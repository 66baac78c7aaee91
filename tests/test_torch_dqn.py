"""The port's value-based losses, gradients and optimizer steps against the
JAX package's, on the same params (JAX `init_params`, carried across with
`DQNModel.load_params`) and the same numpy batch: IDQN, VDN and QMIX with
the GRU critic, with and without return standardisation, QMIX's critic-only
gradient clip, and IDQN with the LSTM critic. f32 on both sides; the JAX GRU
runs its Pallas kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from codebase_tpu.algos.common import make_optimizer as jax_make_optimizer
from codebase_tpu.algos.dqn import DQNModel as JaxDQNModel
from codebase_tpu.config import Config as JaxConfig
from codebase_tpu.envs.lbforaging import parse_lbf_name as jax_parse_lbf_name
from codebase_tpu.ops.running_stats import RunningMeanStd as JaxRunningMeanStd
from codebase_tpu_torch.algos.common import Adam, hard_update
from codebase_tpu_torch.algos.dqn import DQNModel
from codebase_tpu_torch.config import Config
from codebase_tpu_torch.envs.lbforaging import parse_lbf_name
from codebase_tpu_torch.ops.running_stats import RunningMeanStd
from codebase_tpu_torch.utils.params import tree_leaves

torch.set_num_threads(2)
ENV = "lbforaging:Foraging-8x8-2p-3f-v3"
N, T, B = 2, 5, 8
MODEL = dict(name="qnetwork", layers=[128, 128], parameter_sharing=False,
             use_orthogonal_init=True, use_rnn=True)
ALGO = dict(gamma=0.99, double_q=True, standardise_returns=False)


def _models():
    jmodel = JaxDQNModel.create(
        jax_parse_lbf_name(ENV), JaxConfig({**MODEL, "fused_rnn": "interpret"}), JaxConfig(ALGO)
    )
    model = DQNModel.create(parse_lbf_name(ENV), Config(MODEL), Config(ALGO))
    return jmodel, model


def _batch(seed, D=15, A=6, N=N):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, size=B)
    filled = (np.arange(T)[:, None] < lengths[None]).astype(np.float32)
    return dict(
        obss=rng.integers(-1, 8, size=(N, T + 1, B, D)).astype(np.float32),
        actions=rng.integers(0, A, size=(N, T, B)).astype(np.int32),
        rewards=(rng.random((N, T, B)) * (rng.random((N, T, B)) < 0.3)).astype(np.float32),
        dones=np.concatenate([np.zeros((1, B)), (np.arange(T)[:, None] == lengths[None] - 1)], 0).astype(np.float32),
        filled=filled,
        action_mask=None,
    )


def _torch_batch(b):
    out = {k: (torch.tensor(v) if v is not None else None) for k, v in b.items()}
    out["actions"] = out["actions"].long()
    return out


def _jax_batch(b):
    return {k: (jnp.asarray(v) if v is not None else None) for k, v in b.items()}


def _to_torch_model(model, jparams):
    model.load_params(jax.device_get(jparams))


def test_loss_and_grads_match_jax():
    jmodel, model = _models()
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    tparams = jax.jit(jmodel.init_params)(jax.random.PRNGKey(1))
    target = DQNModel.create(parse_lbf_name(ENV), Config(MODEL), Config(ALGO))
    _to_torch_model(model, params)
    _to_torch_model(target, tparams)
    batch = _batch(2)

    loss_fn = lambda p: jmodel.loss(p, tparams, _jax_batch(batch), jmodel.init_rms())[0]  # noqa: E731
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss, _ = model.loss(target, _torch_batch(batch), model.init_rms())
    grads = torch.autograd.grad(loss, model.param_leaves())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-4)
    for g, r in zip(grads, tree_leaves(jax.device_get(jgrads["critic"]))):
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("grad_clip", [0.05, 100.0])  # the clip fires / never fires
def test_three_optimizer_steps_match_optax(grad_clip):
    """Adam + global-norm clip + a hard target copy every 2 updates."""
    jmodel, model = _models()
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(3))
    tparams = jax.tree.map(jnp.copy, params)
    _to_torch_model(model, params)
    target = DQNModel.create(parse_lbf_name(ENV), Config(MODEL), Config(ALGO))
    _to_torch_model(target, params)
    lr, interval = 1e-3, 2
    opt = jax_make_optimizer("adam", lr, grad_clip)
    opt_state = opt.init(params)
    topt = Adam(model.param_leaves(), lr, grad_clip)

    @jax.jit
    def jstep(params, tparams, opt_state, batch):
        (loss, _), grads = jax.value_and_grad(jmodel.loss, has_aux=True)(
            params, tparams, batch, jmodel.init_rms()
        )
        upd, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, loss

    for u in range(1, 4):
        batch = _batch(10 + u)
        params, opt_state, jloss = jstep(params, tparams, opt_state, _jax_batch(batch))
        loss, _ = model.loss(target, _torch_batch(batch), model.init_rms())
        topt.step(torch.autograd.grad(loss, model.param_leaves()))
        if u % interval == 0:
            tparams = jax.tree.map(jnp.copy, params)
            hard_update(target.param_leaves(), model.param_leaves())
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-4, err_msg=f"loss {u}")
        # atol 5e-2 * lr: a gradient entry that cancels to ~1e-7 keeps only
        # its leading digits in f32, and Adam's g / (sqrt(v) + eps) turns
        # that into a step of up to lr in either package (a wrong Adam or
        # clip rule moves every entry by O(lr))
        for p, r in zip(model.param_leaves(), tree_leaves(jax.device_get(params["critic"]))):
            np.testing.assert_allclose(p.detach().numpy(), r, rtol=2e-4, atol=5e-2 * lr, err_msg=f"step {u}")
        for p, r in zip(target.param_leaves(), tree_leaves(jax.device_get(tparams["critic"]))):
            np.testing.assert_allclose(p.detach().numpy(), r, rtol=2e-4, atol=5e-2 * lr, err_msg=f"target {u}")


def test_adam_clip_is_optax_rule_not_clip_grad_norm():
    """optax scales by max_norm / norm; torch's clip_grad_norm_ by
    max_norm / (norm + 1e-6). At a norm of 1e-3 and max_norm 5e-4 the two
    differ by 0.1%."""
    g = [torch.full((4,), 5e-4)]  # norm 1e-3
    p = [torch.zeros(4)]
    opt = Adam(p, lr=1.0, grad_clip=5e-4)
    opt.step(g)
    jopt = jax_make_optimizer("adam", 1.0, 5e-4)
    jp = [jnp.zeros(4)]
    upd, _ = jopt.update([jnp.full((4,), 5e-4)], jopt.init(jp), jp)
    np.testing.assert_allclose(p[0].numpy(), np.asarray(upd[0]), rtol=1e-6)
    np.testing.assert_allclose(opt.mu[0].numpy(), 0.1 * 2.5e-4, rtol=1e-6)


# VDN and QMIX: three agents sharing one GRU critic (the kernels' G=3 case
# on the card), the team reward of agent 0
ENV3 = "lbforaging:Foraging-8x8-3p-2f-v3"
MIXING = dict(embed_dim=16, hypernet_layers=2, hypernet_embed=8)


def _family(name, standardise_returns=False, use_rnn=True):
    model_cfg = {**MODEL, "name": name, "parameter_sharing": True, "use_rnn": use_rnn, "mixing": MIXING}
    algo = {**ALGO, "standardise_returns": standardise_returns}
    jmodel = JaxDQNModel.create(
        jax_parse_lbf_name(ENV3), JaxConfig({**model_cfg, "fused_rnn": "interpret"}), JaxConfig(algo)
    )
    return jmodel, lambda: DQNModel.create(parse_lbf_name(ENV3), Config(model_cfg), Config(algo))


def _rms_pair(shape, seed):
    """Moments that have seen data, so that denormalising the target matters."""
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(shape).astype(np.float32)
    var = (rng.random(shape) + 0.5).astype(np.float32)
    count = np.float32(37.0)
    return (JaxRunningMeanStd(jnp.asarray(mean), jnp.asarray(var), jnp.asarray(count)),
            RunningMeanStd(torch.tensor(mean), torch.tensor(var), torch.tensor(count)))


@pytest.mark.parametrize("standardise_returns", [False, True])
@pytest.mark.parametrize("name", ["vdn", "qmix", "qnetwork"])
def test_value_decomposition_loss_grads_and_return_moments_match_jax(name, standardise_returns):
    jmodel, make = _family(name, standardise_returns)
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    tparams = jax.jit(jmodel.init_params)(jax.random.PRNGKey(1))
    model, target = make(), make()
    _to_torch_model(model, params)
    _to_torch_model(target, tparams)
    assert set(model.param_tree()) == set(params)
    batch = _batch(4, N=3)
    jrms, rms = _rms_pair(jmodel.init_rms().mean.shape, seed=5)
    assert tuple(model.init_rms().mean.shape) == jmodel.init_rms().mean.shape

    loss_fn = lambda p: jmodel.loss(p, tparams, _jax_batch(batch), jrms)  # noqa: E731
    (jloss, jnew), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    loss, new = model.loss(target, _torch_batch(batch), rms)
    grads = torch.autograd.grad(loss, model.param_leaves())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-4)
    ref = tree_leaves(jax.device_get(jgrads))
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        # atol 1e-6 of the leaf's largest entry: an entry that cancels to
        # ~1e-3 of its leaf's scale keeps only its leading digits in f32
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=1e-6 * max(1.0, np.abs(r).max()))
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(new, f).numpy(), np.asarray(getattr(jnew, f)), rtol=2e-4, err_msg=f)
    # the moments count every (t, b) cell, filled or not
    expected_count = 37.0 + (batch["filled"].size if standardise_returns else 0)
    assert float(new.count) == pytest.approx(expected_count)


def test_qmix_three_adam_steps_clip_the_critic_only_like_optax():
    """Adam behind a global-norm clip that fires, masked to the critic as
    `optax.masked(clip_by_global_norm)` is: the mixer's leaves are neither
    counted in the norm nor scaled. Critic, mixer and the target's mixer
    (hard copy every 2 updates) held to optax; the same steps with the
    whole tree clipped end elsewhere."""
    jmodel, make = _family("qmix")
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(3))
    tparams = jax.tree.map(jnp.copy, params)
    model, target, whole = make(), make(), make()
    for m in (model, target, whole):
        _to_torch_model(m, params)
    lr, grad_clip, interval = 1e-3, 0.05, 2
    opt = jax_make_optimizer("adam", lr, grad_clip, clip_mask={"critic": True, "mixer": False})
    opt_state = opt.init(params)
    mask = model.clip_mask()
    assert mask == [True] * len(tree_leaves(model.critic.param_tree())) + [False] * 14
    topt = Adam(model.param_leaves(), lr, grad_clip, clip_mask=mask)
    wopt = Adam(whole.param_leaves(), lr, grad_clip)

    @jax.jit
    def jstep(params, tparams, opt_state, batch):
        (loss, _), grads = jax.value_and_grad(jmodel.loss, has_aux=True)(
            params, tparams, batch, jmodel.init_rms()
        )
        upd, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, loss

    for u in range(1, 4):
        batch = _batch(20 + u, N=3)
        params, opt_state, jloss = jstep(params, tparams, opt_state, _jax_batch(batch))
        loss, _ = model.loss(target, _torch_batch(batch), model.init_rms())
        grads = torch.autograd.grad(loss, model.param_leaves())
        critic_norm = torch.sqrt(sum((g * g).sum() for g, m in zip(grads, mask) if m))
        assert float(critic_norm) > grad_clip, "the clip must fire for this test to see its scope"
        topt.step(grads)
        wloss, _ = whole.loss(target, _torch_batch(batch), whole.init_rms())
        wopt.step(torch.autograd.grad(wloss, whole.param_leaves()))
        if u % interval == 0:
            tparams = jax.tree.map(jnp.copy, params)
            hard_update(target.param_leaves(), model.param_leaves())
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-4, err_msg=f"loss {u}")
        # atol 5e-2 * lr as in test_three_optimizer_steps_match_optax
        for part, p_tree, r_tree in (("online", model.param_tree(), params), ("target", target.param_tree(), tparams)):
            for p, r in zip(tree_leaves(p_tree), tree_leaves(jax.device_get(r_tree))):
                np.testing.assert_allclose(p.detach().numpy(), r, rtol=2e-4, atol=5e-2 * lr, err_msg=f"{part} {u}")
    # whole-tree clipping moves the mixer differently (its first Adam step
    # is scale-free, the later ones are not)
    gaps = [float((p - q).detach().abs().max()) for p, q in
            zip(tree_leaves(whole.mixer.param_tree()), tree_leaves(model.mixer.param_tree()))]
    assert max(gaps) > 0.2 * lr


def test_idqn_loss_with_the_lstm_critic_matches_jax():
    """Recurrent IDQN with `use_rnn=lstm`: the plain per-step cell on both
    sides (the JAX package has no LSTM kernel). Loss at 1e-5, grads 2e-4."""
    jmodel, make = _family("qnetwork", use_rnn="lstm")
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(6))
    tparams = jax.jit(jmodel.init_params)(jax.random.PRNGKey(7))
    model, target = make(), make()
    _to_torch_model(model, params)
    _to_torch_model(target, tparams)
    assert model.critic.param_tree()["rnn"][0]["w_hh"].shape == (1, 128, 4 * 128)
    batch = _batch(8, N=3)
    loss_fn = lambda p: jmodel.loss(p, tparams, _jax_batch(batch), jmodel.init_rms())[0]  # noqa: E731
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss, _ = model.loss(target, _torch_batch(batch), model.init_rms())
    grads = torch.autograd.grad(loss, model.param_leaves())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for g, r in zip(grads, tree_leaves(jax.device_get(jgrads))):
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["vdn", "qmix"])
def test_mixed_return_standardisation_diverges_from_init_in_both_packages(name):
    """A trap of the reference semantics, not of the port: with a fixed
    target net (its first `target_update_interval_or_tau` updates), the
    team target is denormalised with the running std, so the returns' std
    is the target's spread times the previous std. Where the fresh target's
    spread over states exceeds 1, the moments grow geometrically. Both
    packages follow the same path, call after call."""
    jmodel, make = _family(name, standardise_returns=True, use_rnn=False)
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(9))
    model = make()
    _to_torch_model(model, params)
    jrms, rms = jmodel.init_rms(), model.init_rms()
    jloss = jax.jit(lambda r, b: jmodel.loss(params, params, b, r))
    variances = []
    for k in range(4):
        batch = _batch(30 + k, N=3)
        (_, jrms), (_, rms) = jloss(jrms, _jax_batch(batch)), model.loss(model, _torch_batch(batch), rms)
        for f in ("mean", "var"):
            np.testing.assert_allclose(getattr(rms, f).detach().numpy(), np.asarray(getattr(jrms, f)),
                                       rtol=2e-4, err_msg=f"{f} after call {k}")
        variances.append(float(rms.var[0]))
    assert all(b > 2 * a for a, b in zip(variances[1:], variances[2:])), variances


# ---------------------------------------------------------------- masks
# SMAClite 3m: three agents, 27 fractional features, 9 actions of which the
# mask allows a few; the GRU critic (the JAX kernel in interpret mode)

SMAC = "smaclite:3m-v0"
SN, SD, SA = 3, 27, 9


def _masked_family(name, double_q=True):
    from codebase_tpu.envs.smaclite import parse_smaclite_name as jax_parse_smaclite_name
    from codebase_tpu_torch.envs.smaclite import parse_smaclite_name

    model_cfg = {**MODEL, "name": name, "mixing": MIXING}
    algo = {**ALGO, "double_q": double_q}
    jmodel = JaxDQNModel.create(
        jax_parse_smaclite_name(SMAC), JaxConfig({**model_cfg, "fused_rnn": "interpret"}), JaxConfig(algo)
    )
    assert jmodel.use_action_masks
    return jmodel, lambda: DQNModel.create(parse_smaclite_name(SMAC), Config(model_cfg), Config(algo))


def _random_masks(rng, shape, p_valid=0.35):
    """(..., A) masks: each action valid with p_valid, STOP (1) always; a
    share of rows NOOP-only, as a dead agent's."""
    mask = (rng.random(shape) < p_valid).astype(np.float32)
    mask[..., 0] = 0.0
    mask[..., 1] = 1.0
    dead = rng.random(shape[:-1]) < 0.15
    mask[dead] = 0.0
    mask[dead, 0] = 1.0
    return mask


def _pick_valid(rng, mask):
    return (rng.random(mask.shape) * mask).argmax(-1)


def _masked_batch(seed):
    """A reference-layout batch whose masks allow few actions; padded steps
    (past each episode's end) carry an all-ones mask, as the collector
    writes them, and action 0."""
    rng = np.random.default_rng(seed)
    b = _batch(seed, D=SD, A=SA, N=SN)
    b["obss"] = rng.random((SN, T + 1, B, SD)).astype(np.float32)
    mask = _random_masks(rng, (SN, T + 1, B, SA))
    padded = np.concatenate([np.zeros((1, B)), 1.0 - b["filled"]], 0) > 0  # (T+1, B)
    mask[:, padded] = 1.0
    b["action_mask"] = mask
    b["actions"] = np.where(b["filled"][None] > 0, _pick_valid(rng, mask[:, :-1]), 0).astype(np.int32)
    return b


@pytest.mark.parametrize("name,double_q", [("qnetwork", True), ("qmix", True), ("qnetwork", False)])
def test_masked_double_q_loss_and_grads_match_jax(name, double_q):
    """The target side sees masked actions at -1e8: the target Q, and under
    double Q the online Q before its argmax. Loss and gradients at rtol
    2e-4 on injected params; without the mask the loss moves."""
    jmodel, make = _masked_family(name, double_q)
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    tparams = jax.jit(jmodel.init_params)(jax.random.PRNGKey(1))
    model, target = make(), make()
    _to_torch_model(model, params)
    _to_torch_model(target, tparams)
    assert model.use_action_masks
    batch = _masked_batch(40)
    loss_fn = lambda p: jmodel.loss(p, tparams, _jax_batch(batch), jmodel.init_rms())[0]  # noqa: E731
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss, _ = model.loss(target, _torch_batch(batch), model.init_rms())
    grads = torch.autograd.grad(loss, model.param_leaves())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-4)
    ref = tree_leaves(jax.device_get(jgrads))
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=1e-6 * max(1.0, np.abs(r).max()))
    unmasked = _torch_batch({**batch, "action_mask": np.ones_like(batch["action_mask"])})
    assert abs(model.loss(target, unmasked, model.init_rms())[0].item() - loss.item()) > 1e-3 * abs(loss.item())


def test_masked_policy_is_greedy_over_valid_actions_and_explores_uniformly():
    """Greedy (epsilon 0): the JAX policy's actions on injected params, all
    valid. Epsilon 1: uniform over each agent's valid actions (20,000 envs,
    every frequency within 5 sigma), never an invalid one. Epsilon 0.5: one
    coin per env flips all its agents, so all agents act greedily with
    probability 0.5 + 0.5 * prod(1 / valid count), within 5 sigma."""
    jmodel, make = _masked_family("qnetwork")
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(2))
    model = make()
    _to_torch_model(model, params)
    rng = np.random.default_rng(3)
    E = 64
    obs = rng.random((E, SN, SD)).astype(np.float32)
    mask = _random_masks(rng, (E, SN, SA))
    _, jgreedy = jmodel.policy(params, 0.0)(jmodel.critic.init_hiddens(E), jnp.asarray(obs), jnp.asarray(mask),
                                            jax.random.PRNGKey(4))
    gen = torch.Generator().manual_seed(0)
    _, greedy = model.policy(0.0)(model.critic.init_hiddens(E), torch.tensor(obs), torch.tensor(mask), gen)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jgreedy))
    assert np.all(np.take_along_axis(mask, greedy.numpy()[..., None], -1) == 1)

    n = 20_000
    row = np.zeros((SN, SA), np.float32)
    row[0, [1, 3, 7]] = 1.0
    row[1, [1, 2, 4, 6, 8]] = 1.0
    row[2, 0] = 1.0  # dead: NOOP only
    big_obs = torch.tensor(np.repeat(obs[:1], n, 0))
    big_mask = torch.tensor(np.repeat(row[None], n, 0))
    _, acts = model.policy(1.0)(model.critic.init_hiddens(n), big_obs, big_mask, gen)
    acts = acts.numpy()
    for i in range(SN):
        valid = row[i] > 0
        freq = np.bincount(acts[:, i], minlength=SA) / n
        p = valid / valid.sum()
        assert np.all(freq[~valid] == 0)
        assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-12), (i, freq)
    _, g1 = model.policy(0.0)(model.critic.init_hiddens(1), big_obs[:1], big_mask[:1], gen)
    _, half = model.policy(0.5)(model.critic.init_hiddens(n), big_obs, big_mask, gen)
    all_greedy = (half.numpy() == g1.numpy()).all(1).mean()
    p = 0.5 + 0.5 / (3 * 5 * 1)
    assert abs(all_greedy - p) <= 5 * np.sqrt(p * (1 - p) / n), all_greedy


@pytest.mark.parametrize("env_name", ["smaclite:2m-v0", "rware-tiny-2ag-v2", "lbforaging:Foraging-8x8-2p-3f-v3"])
def test_replay_dtypes_follow_jax(env_name):
    """Replay stores obs in bf16 only where the env's obs are integers (RWARE,
    LBF), and f32 with f32 masks for SMAClite's fractional obs; masks only
    for envs that mask, as the JAX package's buffer."""
    from codebase_tpu.algos.dqn import build_train_functions as jax_build_train_functions
    from codebase_tpu.config import load_config as jax_load_config
    from codebase_tpu.envs.factory import make_env as jax_make_env
    from codebase_tpu_torch.algos.dqn import build_train_functions
    from codebase_tpu_torch.config import load_config
    from codebase_tpu_torch.envs.factory import make_env

    argv = ["+algorithm=idqn", "algorithm.buffer_size=4", "algorithm.batch_size=2"]
    jcfg, cfg = jax_load_config(argv), load_config(argv)
    jcfg.algorithm.parallel_envs = cfg.algorithm.parallel_envs = 2
    _, jinit, _, _ = jax_build_train_functions(jax_make_env(env_name, time_limit=6), None, jcfg.algorithm, 6)
    jbuf = jinit(jax.random.PRNGKey(0)).buffer
    env = make_env(env_name, time_limit=6)
    buf = build_train_functions(env, env, cfg.algorithm, 6, torch.device("cpu"))[0](0).buffer
    assert str(buf.obs.dtype).removeprefix("torch.") == str(jbuf.obs.dtype)
    assert (buf.action_mask is None) == (jbuf.action_mask is None) == (not env.has_action_mask)
    if buf.action_mask is not None:
        assert buf.action_mask.dtype == torch.float32 and str(jbuf.action_mask.dtype) == "float32"
    assert tuple(buf.obs.shape) == tuple(jbuf.obs.shape)
