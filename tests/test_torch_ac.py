"""The port's actor-critic family against the JAX package's, on the same
params (JAX `init_params`, carried across with `ACModel.load_params`) and
the same numpy inputs: the masked categorical, n-step returns, values,
log-probs and returns with and without return standardisation, the A2C and
PPO losses and gradients, three A2C updates against optax, one whole PPO
update in float64, the target-refresh rule and the step count. The JAX GRU
runs its Pallas kernel in interpret mode (H=128); the port its plain
recurrence. Random draws cannot match between the packages: sampling is
compared by frequency, and everything after the draws on the same rollout."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from codebase_tpu.algos.ac import ACModel as JaxACModel
from codebase_tpu.algos.common import make_optimizer as jax_make_optimizer
from codebase_tpu.algos.common import soft_update as jax_soft_update
from codebase_tpu.config import Config as JaxConfig
from codebase_tpu.config import load_config as jax_load_config
from codebase_tpu.envs.lbforaging import parse_lbf_name as jax_parse_lbf_name
from codebase_tpu.models import distributions as JD
from codebase_tpu.ops.returns import nstep_returns as jax_nstep_returns
from codebase_tpu.ops.running_stats import RunningMeanStd as JaxRunningMeanStd
from codebase_tpu_torch.algos.ac import ACModel, ACTrainState, build_train_functions
from codebase_tpu_torch.algos.common import Adam
from codebase_tpu_torch.config import Config, load_config
from codebase_tpu_torch.envs.lbforaging import parse_lbf_name
from codebase_tpu_torch.envs.vector import Rollout
from codebase_tpu_torch.models import distributions as D
from codebase_tpu_torch.ops.returns import nstep_returns
from codebase_tpu_torch.ops.running_stats import RunningMeanStd
from codebase_tpu_torch.utils.params import params_from_numpy, tree_leaves

torch.set_num_threads(2)
ENV = "lbforaging:Foraging-8x8-2p-3f-v3"
N, T, E, OBS, A = 2, 5, 8, 15, 6
CPU = torch.device("cpu")


def _net(use_rnn):
    return dict(layers=[128, 128], parameter_sharing=False, use_orthogonal_init=True, use_rnn=use_rnn)


def _cfgs(name="a2c", centralised=False, use_rnn=False, standardise_returns=False):
    model = dict(name=name, actor=_net(use_rnn), critic={**_net(use_rnn), "centralised": centralised})
    algo = dict(gamma=0.99, n_steps=3, entropy_coef=0.01, value_loss_coef=0.5,
                standardise_returns=standardise_returns, num_epochs=4, ppo_clip=0.2)
    jmodel = {**model, "actor": {**model["actor"], "fused_rnn": "interpret"},
              "critic": {**model["critic"], "fused_rnn": "interpret"}}
    return (JaxConfig(jmodel), JaxConfig(algo)), (Config(model), Config(algo))


def _models(seed=0, **kw):
    """(JAX model, its params, the port's model holding the same params)."""
    (jm, ja), (m, a) = _cfgs(**kw)
    jmodel = JaxACModel.create(jax_parse_lbf_name(ENV), jm, ja)
    model = ACModel.create(parse_lbf_name(ENV), m, a)
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(seed))
    model.load_params(jax.device_get(params))
    return jmodel, params, model


def _target(model, jparams_critic):
    """A target critic for the port holding the JAX critic params."""
    target = copy.deepcopy(model.critic).requires_grad_(False)
    target.load_params(params_from_numpy(jax.device_get(jparams_critic), dtype=target.param_leaves()[0].dtype))
    return target


def _rollout(seed, E=E, dtype=np.float32):
    """A numpy rollout in the collector's layout: obs (T+1, E, N, D),
    actions, rewards (T, E, N), dones (T+1, E), filled (T, E); episode
    lengths random in 1..T, one env running all T steps."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, size=E)
    lengths[0] = T
    filled = (np.arange(T)[:, None] < lengths[None]).astype(dtype)
    return dict(
        obs=rng.integers(-1, 8, size=(T + 1, E, N, OBS)).astype(dtype),
        actions=rng.integers(0, A, size=(T, E, N)),
        rewards=(rng.random((T, E, N)) * (rng.random((T, E, N)) < 0.4) * filled[..., None]).astype(dtype),
        dones=np.concatenate([np.zeros((1, E)), np.arange(T)[:, None] == lengths[None] - 1]).astype(dtype),
        filled=filled,
        action_mask=np.ones((T + 1, E, N, A), dtype),
    )


def _torch_rollout(r):
    t = {k: torch.tensor(v) for k, v in r.items()}
    return Rollout(obs=t["obs"], actions=t["actions"].long(), rewards=t["rewards"], stat_rewards=t["rewards"],
                   dones=t["dones"], filled=t["filled"], action_mask=t["action_mask"])


def _jax_inputs(r):
    """JAX-layout inputs of the losses: (obs_agents (N, T+1, E, D), amask
    (N, T+1, E, A), actions, rewards, dones, filled)."""
    return (jnp.moveaxis(jnp.asarray(r["obs"]), 2, 0), jnp.moveaxis(jnp.asarray(r["action_mask"]), 2, 0),
            jnp.asarray(r["actions"], jnp.int32), jnp.asarray(r["rewards"]), jnp.asarray(r["dones"]),
            jnp.asarray(r["filled"]))


def _rms_pair(seed):
    """Return moments that have seen data, so that denormalising matters."""
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(N).astype(np.float32)
    var = (rng.random(N) + 0.5).astype(np.float32)
    count = np.float32(37.0)
    return (JaxRunningMeanStd(jnp.asarray(mean), jnp.asarray(var), jnp.asarray(count)),
            RunningMeanStd(torch.tensor(mean), torch.tensor(var), torch.tensor(count)))


def _assert_leaves(got, ref, rtol, atol_of=lambda r: 1e-6 * max(1.0, np.abs(r).max()), msg=""):
    got, ref = list(got), tree_leaves(jax.device_get(ref))
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        # an entry that cancels to ~1e-6 of its leaf's scale keeps only its
        # leading digits in f32
        np.testing.assert_allclose(g.detach().numpy(), r, rtol=rtol, atol=atol_of(r), err_msg=f"{msg} leaf {i}")


# ---------------------------------------------------------------- distributions


@pytest.mark.parametrize("masked", [False, True])
def test_mask_log_prob_and_entropy_match_jax(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 4, A)) * 3).astype(np.float32)
    actions = rng.integers(0, A, size=(3, 4))
    mask = None
    if masked:
        mask = (rng.random((3, 4, A)) < 0.6).astype(np.float32)
        mask[..., 0] = 1.0  # at least one legal action per row
        mask[0, 0] = 0.0
        mask[0, 0, 2] = 1.0  # a row with one legal action: entropy 0
    tm = None if mask is None else torch.tensor(mask)
    got = D.apply_mask(torch.tensor(logits), tm)
    ref = JD.apply_mask(jnp.asarray(logits), None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(D.log_prob(got, torch.tensor(actions)).numpy(),
                               np.asarray(JD.log_prob(ref, jnp.asarray(actions))), rtol=1e-6, atol=1e-6)
    ent = D.entropy(got)
    np.testing.assert_allclose(ent.numpy(), np.asarray(JD.entropy(ref)), rtol=1e-6, atol=1e-6)
    assert torch.isfinite(ent).all()
    if masked:
        assert float(ent[0, 0]) == 0.0
    np.testing.assert_array_equal(D.mode(got).numpy(), np.asarray(JD.mode(ref)))


def test_sample_frequencies_match_the_softmax_and_never_draw_a_masked_action():
    """200,000 draws per row: every action's frequency within 5 sigma of its
    softmax probability; masked actions are never drawn."""
    rng = np.random.default_rng(1)
    logits = torch.tensor((rng.standard_normal((3, A)) * 1.5).astype(np.float32))
    mask = torch.ones(3, A)
    mask[1, [0, 4]] = 0.0
    mask[2, 1:] = 0.0
    logits = D.apply_mask(logits, mask)
    n = 200_000
    draws = D.sample(torch.Generator().manual_seed(0), logits.expand(n, 3, A))
    assert draws.shape == (n, 3) and draws.dtype == torch.int64
    p = torch.softmax(logits.double(), -1).numpy()
    freq = np.stack([np.bincount(draws[:, i].numpy(), minlength=A) for i in range(3)]) / n
    sigma = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq - p) <= 5 * sigma + 1e-12), (freq, p)
    assert np.all(freq[mask.numpy() == 0] == 0)
    assert np.all(freq[2] == [1, 0, 0, 0, 0, 0])


def test_policy_carries_the_actor_hiddens_like_jax():
    """The rollout policy's carry is the recurrent actor's hiddens: after
    two steps it equals the JAX actor's, and the actions are legal."""
    jmodel, params, model = _models(seed=3, use_rnn=True)
    rng = np.random.default_rng(4)
    obs = [rng.integers(-1, 8, size=(E, N, OBS)).astype(np.float32) for _ in range(2)]
    act = model.policy()
    carry, jcarry = model.actor.init_hiddens(E), jmodel.actor.init_hiddens(E)
    gen = torch.Generator().manual_seed(0)
    for o in obs:
        carry, actions = act(carry, torch.tensor(o), None, gen)
        _, jcarry = jmodel.actor.apply(params["actor"], jnp.moveaxis(jnp.asarray(o), 1, 0)[:, None], jcarry)
        assert actions.shape == (E, N) and int(actions.min()) >= 0 and int(actions.max()) < A
    np.testing.assert_allclose(carry.numpy(), np.asarray(jcarry), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- returns


@pytest.mark.parametrize("nsteps", [1, 3, 5, 10])
def test_nstep_returns_match_jax(nsteps):
    rng = np.random.default_rng(nsteps)
    Tn, B = 12, 8
    lengths = rng.integers(1, Tn + 1, size=B)
    done = (np.arange(Tn + 1)[:, None] >= lengths[None]).astype(np.float32)  # state t terminal
    done = np.repeat(done[..., None], N, -1)
    rewards = rng.standard_normal((Tn, B, N)).astype(np.float32)
    values = rng.standard_normal((Tn + 1, B, N)).astype(np.float32)
    got = nstep_returns(torch.tensor(rewards), torch.tensor(done), torch.tensor(values), nsteps, 0.97)
    ref = jax_nstep_returns(jnp.asarray(rewards), jnp.asarray(done), jnp.asarray(values), nsteps, 0.97)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # values[T] is never used
    values[-1] = 1e6
    again = nstep_returns(torch.tensor(rewards), torch.tensor(done), torch.tensor(values), nsteps, 0.97)
    assert torch.equal(again, got)


# ---------------------------------------------------------------- forwards


@pytest.mark.parametrize("use_rnn", [False, True])
@pytest.mark.parametrize("centralised", [False, True])
@pytest.mark.parametrize("standardise_returns", [False, True])
def test_values_log_probs_and_returns_match_jax(use_rnn, centralised, standardise_returns):
    jmodel, params, model = _models(seed=1, use_rnn=use_rnn, centralised=centralised,
                                    standardise_returns=standardise_returns)
    tparams = jax.jit(jmodel.init_params)(jax.random.PRNGKey(2))
    target = _target(model, tparams["critic"])
    r = _rollout(5)
    obs_agents, amask, actions, rewards, dones, _ = _jax_inputs(r)
    tobs = torch.tensor(r["obs"]).permute(2, 0, 1, 3)
    tree = model.critic.param_tree()
    first = tree["first"] if use_rnn else tree["layers"][0]
    assert first["w"].shape[1] == (N * OBS if centralised else OBS)  # centralised: all agents' obs

    values = model.values(model.critic, tobs)
    np.testing.assert_allclose(values.detach().numpy(), np.asarray(jmodel.values(params["critic"], obs_agents)),
                               rtol=1e-5, atol=1e-5)
    lp, ent = model.log_probs_entropy(tobs[:, :-1], torch.tensor(r["actions"]))
    jlp, jent = jmodel.log_probs_entropy(params["actor"], obs_agents[:, :-1], actions, amask[:, :-1])
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ent.detach().numpy(), np.asarray(jent), rtol=1e-5, atol=1e-5)

    jrms, rms = _rms_pair(6)
    returns, new = model.compute_returns(target, tobs, torch.tensor(r["rewards"]), torch.tensor(r["dones"]), rms)
    jreturns, jnew = jmodel.compute_returns(tparams["critic"], obs_agents, rewards, dones, jrms)
    np.testing.assert_allclose(returns.detach().numpy(), np.asarray(jreturns), rtol=1e-5, atol=1e-5)
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(new, f).numpy(), np.asarray(getattr(jnew, f)), rtol=1e-6, err_msg=f)
    # the moments count every (t, b) cell, filled or not
    assert float(new.count) == pytest.approx(37.0 + (T * E if standardise_returns else 0))


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("name,centralised,use_rnn", [
    ("a2c", False, False), ("a2c", True, True), ("ppo", False, False), ("ppo", True, True)])
def test_loss_and_grads_match_jax(name, centralised, use_rnn):
    """One A2C loss or one PPO epoch (old log-probs perturbed so that some
    ratios leave the clip range): loss, metrics and gradients in f32."""
    jmodel, params, model = _models(seed=7, name=name, centralised=centralised, use_rnn=use_rnn)
    r = _rollout(8)
    obs_agents, amask, actions, _, _, filled = _jax_inputs(r)
    rng = np.random.default_rng(9)
    returns = rng.standard_normal((T, E, N)).astype(np.float32)
    tobs = torch.tensor(r["obs"]).permute(2, 0, 1, 3)[:, :-1]
    targs = (torch.tensor(returns), tobs, torch.tensor(r["actions"]), torch.tensor(r["filled"]))
    jargs = (jnp.asarray(returns), obs_agents[:, :-1], actions, amask[:, :-1], filled)
    if name == "a2c":
        loss, metrics = model.a2c_loss(*targs)
        jfn = lambda p: jmodel.a2c_loss(p, *jargs)  # noqa: E731
    else:
        jlp, _ = jmodel.log_probs_entropy(params["actor"], obs_agents[:, :-1], actions, amask[:, :-1])
        old = (np.asarray(jlp) + rng.normal(0, 0.3, size=jlp.shape)).astype(np.float32)
        loss, metrics = model.ppo_loss(targs[0], torch.tensor(old), *targs[1:])
        jfn = lambda p: jmodel.ppo_loss(p, jargs[0], jnp.asarray(old), *jargs[1:])  # noqa: E731
        ratio = np.exp(np.asarray(jlp) - old)
        assert np.any(ratio > 1.2) and np.any(ratio < 0.8) and np.any(np.abs(ratio - 1) < 0.2)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(params)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-4)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(jmetrics[k]), rtol=2e-4, err_msg=k)
    grads = torch.autograd.grad(loss, model.param_leaves())
    _assert_leaves(grads, jgrads, rtol=2e-4)


# ---------------------------------------------------------------- updates


def _port_state(model, target, lr, grad_clip=False):
    return ACTrainState(model=model, target_critic=target, opt=Adam(model.param_leaves(), lr, grad_clip),
                        generator=torch.Generator().manual_seed(0), ret_rms=model.init_rms())


def _update_fn(algo, **overrides):
    argv = [f"+algorithm={algo}"] + [f"{k}={v}" for k, v in overrides.items()]
    cfg = load_config(argv)
    cfg.algorithm.parallel_envs = E
    env = parse_lbf_name(ENV)
    return build_train_functions(env, env, cfg.algorithm, T, CPU)[3], jax_load_config(argv).algorithm


@pytest.mark.parametrize("grad_clip,standardise_returns", [(False, False), (0.05, True)])
def test_three_a2c_updates_match_optax(grad_clip, standardise_returns):
    """Three A2C updates through the port's `update` (returns, loss, Adam
    over the whole tree, clip on every leaf when given, target refresh with
    the pre-increment count) against the JAX model's functions and optax.
    With tau = 80 and 8 envs x t_max 5: env steps 0, 40, 80, so the target
    takes the critic after updates 1 and 3, not 2."""
    lr = 1e-3
    over = {"algorithm.lr": lr, "algorithm.grad_clip": str(grad_clip).lower(),
            "algorithm.standardise_returns": str(standardise_returns).lower(),
            "algorithm.target_update_interval_or_tau": 80, "algorithm.n_steps": 3}
    update, jcfg = _update_fn("ia2c", **over)
    jmodel, params, model = _models(seed=11, standardise_returns=standardise_returns)
    target = _target(model, params["critic"])
    tcritic = params["critic"]
    opt = jax_make_optimizer(jcfg.optimizer, lr, jcfg.grad_clip)
    opt_state = opt.init(params)
    state = _port_state(model, target, lr, grad_clip)
    jrms = jmodel.init_rms()

    @jax.jit
    def jstep(params, tcritic, opt_state, rms, r):
        obs_agents, amask, actions, rewards, dones, filled = r
        returns, rms = jmodel.compute_returns(tcritic, obs_agents, rewards, dones, rms)
        (loss, m), grads = jax.value_and_grad(jmodel.a2c_loss, has_aux=True)(
            params, jax.lax.stop_gradient(returns), obs_agents[:, :-1], actions, amask[:, :-1], filled)
        upd, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, rms, m

    env_steps = 0
    for u in range(1, 4):
        r = _rollout(20 + u)
        params, opt_state, jrms, jm = jstep(params, tcritic, opt_state, jrms, _jax_inputs(r))
        if env_steps % 80 == 0:
            tcritic = params["critic"]
        env_steps += int(r["filled"].sum(0).max()) * E
        metrics = update(state, _torch_rollout(r))
        state.env_steps += int(r["filled"].sum(0).max()) * E
        assert state.updates == u and state.env_steps == env_steps == 40 * u
        np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=2e-4, err_msg=f"loss {u}")
        # atol 5e-2 * lr: an entry whose gradient cancels to ~1e-7 keeps
        # only its leading digits in f32, and Adam turns that into a step
        # of up to lr in either package
        atol = lambda r: 5e-2 * lr  # noqa: E731
        _assert_leaves(model.param_leaves(), params, rtol=2e-4, atol_of=atol, msg=f"params {u}")
        _assert_leaves(state.target_critic.param_leaves(), tcritic, rtol=2e-4, atol_of=atol, msg=f"target {u}")
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(state.ret_rms, f).numpy(), np.asarray(getattr(jrms, f)), rtol=1e-5)
    assert torch.equal(state.target_critic.param_leaves()[0], model.critic.param_leaves()[0])


def test_ppo_update_matches_jax_in_float64():
    """One whole PPO update (MAPPO: old log-probs of the pre-update actor,
    4 full-batch epochs each with an Adam step, the epochs' mean metrics)
    in float64 on both sides: the clip boundary amplifies f32 round-off over
    epochs, so f32 could not resolve 1e-9."""
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        lr = 1e-2
        update, jcfg = _update_fn("mappo", **{"algorithm.lr": lr})
        jmodel, params, _ = _models(seed=13, name="ppo", centralised=True)
        params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
        _, (m, a) = _cfgs(name="ppo", centralised=True)
        model = ACModel.create(parse_lbf_name(ENV), m, a).double()
        model.load_params(jax.device_get(params))
        state = _port_state(model, _target(model, params["critic"]), lr)
        r = _rollout(30, dtype=np.float64)
        obs_agents, amask, actions, rewards, dones, filled = _jax_inputs(r)
        opt = jax_make_optimizer(jcfg.optimizer, lr, jcfg.grad_clip)
        opt_state = opt.init(params)

        returns, _ = jmodel.compute_returns(params["critic"], obs_agents, rewards, dones, jmodel.init_rms())
        obs_in, amask_in = obs_agents[:, :-1], amask[:, :-1]
        old, _ = jmodel.log_probs_entropy(params["actor"], obs_in, actions, amask_in)
        grad_fn = jax.jit(jax.value_and_grad(jmodel.ppo_loss, has_aux=True))
        epochs = []
        for _ in range(4):
            (_, jm), grads = grad_fn(params, returns, old, obs_in, actions, amask_in, filled)
            upd, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, upd)
            epochs.append(jm)
        assert np.asarray(returns).dtype == np.float64

        metrics = update(state, _torch_rollout(r))
        assert model.param_leaves()[0].dtype == torch.float64 and state.opt.count == 4
        for k, v in metrics.items():
            np.testing.assert_allclose(v.item(), np.mean([float(e[k]) for e in epochs]), rtol=1e-9, err_msg=k)
        # atol 1e-12: an Adam step from a gradient that cancels to ~1e-16
        _assert_leaves(model.param_leaves(), params, rtol=1e-9, atol_of=lambda r: 1e-12)
        # env_steps 0 is a multiple of tau: the target is the post-update critic
        _assert_leaves(state.target_critic.param_leaves(), params["critic"], rtol=1e-9, atol_of=lambda r: 1e-12)
    finally:
        jax.config.update("jax_enable_x64", x64)


@pytest.mark.parametrize("env_steps,tau,refresh", [
    (0, 200, "hard"), (120, 200, "none"), (400, 200, "hard"), (120, 1.0, "none"), (120, 0.25, "polyak")])
def test_target_refresh_rule(env_steps, tau, refresh):
    """The target takes the post-update critic when the count from before
    the iteration is a multiple of tau (> 1); keeps its params otherwise
    and at tau == 1; is blended as the JAX package's `soft_update` at tau < 1."""
    update, _ = _update_fn("ia2c", **{"algorithm.target_update_interval_or_tau": tau})
    jmodel, params, model = _models(seed=17)
    tparams = jax.jit(jmodel.init_params)(jax.random.PRNGKey(18))
    state = _port_state(model, _target(model, tparams["critic"]), 1e-3)
    state.env_steps = env_steps
    update(state, _torch_rollout(_rollout(40)))
    assert state.env_steps == env_steps and state.updates == 1
    critic = [p.detach().numpy() for p in model.critic.param_leaves()]
    old = tree_leaves(jax.device_get(tparams["critic"]))
    expected = {"hard": critic, "none": old, "polyak": jax_soft_update(old, critic, tau)}[refresh]
    for got, ref in zip(state.target_critic.param_leaves(), expected):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)
    assert any(not np.array_equal(c, o) for c, o in zip(critic, old))  # the update moved the critic


def test_step_count_is_t_max_times_envs():
    """env steps advance by the longest episode of the rollout times the
    envs (every env is stepped until the last one ends), not by the filled
    steps; one update per iteration. `evaluate` runs its own episodes and
    leaves the counters alone."""
    cfg = load_config(["+algorithm=ia2c", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=10",
                       "algorithm.eval_episodes=6"])
    cfg.algorithm.parallel_envs = 32
    env = parse_lbf_name("lbforaging:Foraging-5x5-2p-1f-v3")
    init_state, train_iteration, evaluate, _ = build_train_functions(env, env, cfg.algorithm, 10, CPU)
    state = init_state(0)
    ragged = 0
    for i in range(1, 5):
        before = state.env_steps
        out = train_iteration(state)
        lengths = out["episode_lengths"]
        assert state.env_steps - before == int(lengths.max()) * 32 and state.updates == i
        ragged += int(lengths.min() < lengths.max())
    assert ragged, "no rollout had episodes of different lengths"
    steps = state.env_steps
    out = evaluate(state, torch.Generator().manual_seed(1))
    assert out["episode_returns"].shape == (6, 2) and out["episode_lengths"].shape == (6,)
    assert state.env_steps == steps and state.updates == 4


# ---------------------------------------------------------------- masks
# SMAClite 3m: three agents, 27 fractional features, 9 actions of which the
# mask allows a few; dead agents may only NOOP

SMAC = "smaclite:3m-v0"
SN, SOBS, SA = 3, 27, 9


def _masked_models(seed=0, **kw):
    from codebase_tpu.envs.smaclite import parse_smaclite_name as jax_parse_smaclite_name
    from codebase_tpu_torch.envs.smaclite import parse_smaclite_name

    (jm, ja), (m, a) = _cfgs(**kw)
    jmodel = JaxACModel.create(jax_parse_smaclite_name(SMAC), jm, ja)
    model = ACModel.create(parse_smaclite_name(SMAC), m, a)
    assert jmodel.use_action_masks and model.use_action_masks
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(seed))
    model.load_params(jax.device_get(params))
    return jmodel, params, model


def _masked_rollout(seed):
    """A rollout in the collector's layout whose masks allow few actions
    (each valid with p 0.3, STOP always while alive; 20% of the rows
    NOOP-only, a dead agent's), actions drawn among the valid ones, padded
    steps with an all-ones mask and action 0."""
    rng = np.random.default_rng(seed)
    r = _rollout(seed)
    r["obs"] = rng.random((T + 1, E, SN, SOBS)).astype(np.float32)
    mask = (rng.random((T + 1, E, SN, SA)) < 0.3).astype(np.float32)
    mask[..., 0], mask[..., 1] = 0.0, 1.0
    dead = rng.random((T + 1, E, SN)) < 0.2
    mask[dead] = 0.0
    mask[dead, 0] = 1.0
    filled = r["filled"]
    mask[1:][filled == 0] = 1.0  # padded steps
    r["action_mask"] = mask
    r["actions"] = np.where(filled[..., None] > 0, (rng.random(mask[:-1].shape) * mask[:-1]).argmax(-1), 0)
    r["rewards"] = np.repeat(r["rewards"][..., :1], SN, -1)
    return r


@pytest.mark.parametrize("name,centralised,use_rnn", [("a2c", False, False), ("ppo", True, True)])
def test_masked_log_probs_entropy_and_losses_match_jax(name, centralised, use_rnn):
    """Masked logits take -1e8: log-probs, entropy (0 * log 0 adds 0, a
    NOOP-only row has entropy 0), and the A2C or PPO loss, metrics and
    gradients against the JAX model on the same params and rollout."""
    jmodel, params, model = _masked_models(seed=21, name=name, centralised=centralised, use_rnn=use_rnn)
    r = _masked_rollout(22)
    obs_agents, amask, actions, _, _, filled = _jax_inputs(r)
    tobs = torch.tensor(r["obs"]).permute(2, 0, 1, 3)[:, :-1]
    tmask = torch.tensor(r["action_mask"]).permute(2, 0, 1, 3)[:, :-1]
    lp, ent = model.log_probs_entropy(tobs, torch.tensor(r["actions"]), tmask)
    jlp, jent = jmodel.log_probs_entropy(params["actor"], obs_agents[:, :-1], actions, amask[:, :-1])
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ent.detach().numpy(), np.asarray(jent), rtol=1e-5, atol=1e-5)
    assert torch.isfinite(ent).all() and torch.isfinite(lp).all()
    logits = D.apply_mask(model.actor(tobs)[0], tmask)
    one_valid = tmask.sum(-1) == 1
    assert one_valid.any() and bool((D.entropy(logits)[one_valid] == 0).all())
    unmasked, _ = model.log_probs_entropy(tobs, torch.tensor(r["actions"]), torch.ones_like(tmask))
    assert float((unmasked - lp).detach().abs().max()) > 0.1  # the mask matters

    rng = np.random.default_rng(23)
    returns = rng.standard_normal((T, E, SN)).astype(np.float32)
    targs = (torch.tensor(returns), tobs, torch.tensor(r["actions"]), torch.tensor(r["filled"]))
    jargs = (jnp.asarray(returns), obs_agents[:, :-1], actions, amask[:, :-1], filled)
    if name == "a2c":
        loss, metrics = model.a2c_loss(*targs, amask=tmask)
        jfn = lambda p: jmodel.a2c_loss(p, *jargs)  # noqa: E731
    else:
        old = (np.asarray(jlp) + rng.normal(0, 0.3, size=jlp.shape)).astype(np.float32)
        loss, metrics = model.ppo_loss(targs[0], torch.tensor(old), *targs[1:], amask=tmask)
        jfn = lambda p: jmodel.ppo_loss(p, jargs[0], jnp.asarray(old), *jargs[1:])  # noqa: E731
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(params)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-4)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(jmetrics[k]), rtol=2e-4, err_msg=k)
    _assert_leaves(torch.autograd.grad(loss, model.param_leaves()), jgrads, rtol=2e-4)


def test_masked_update_takes_each_action_with_its_observation_mask():
    """One A2C update through the port's `update` on a masked rollout: the
    loss sees `action_mask[:-1]`, the mask of the observation each action
    was taken from (JAX `update`); params after the Adam step equal the JAX
    model's with optax. The masked sampling policy never draws a masked
    action."""
    lr = 1e-3
    argv = ["+algorithm=ia2c", f"algorithm.lr={lr}", "algorithm.n_steps=3"]
    cfg, jcfg = load_config(argv), jax_load_config(argv)
    cfg.algorithm.parallel_envs = E
    from codebase_tpu_torch.envs.smaclite import parse_smaclite_name

    env = parse_smaclite_name(SMAC)
    update = build_train_functions(env, env, cfg.algorithm, T, CPU)[3]
    jmodel, params, model = _masked_models(seed=24)
    state = _port_state(model, _target(model, params["critic"]), lr)
    r = _masked_rollout(25)
    obs_agents, amask, actions, rewards, dones, filled = _jax_inputs(r)
    returns, _ = jax.jit(jmodel.compute_returns)(params["critic"], obs_agents, rewards, dones, jmodel.init_rms())
    (_, jm), grads = jax.jit(jax.value_and_grad(jmodel.a2c_loss, has_aux=True))(
        params, returns, obs_agents[:, :-1], actions, amask[:, :-1], filled)
    opt = jax_make_optimizer(jcfg.algorithm.optimizer, lr, jcfg.algorithm.grad_clip)
    upd, _ = opt.update(grads, opt.init(params), params)
    params = optax.apply_updates(params, upd)
    metrics = update(state, _torch_rollout(r))
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=2e-4)
    _assert_leaves(model.param_leaves(), params, rtol=2e-4, atol_of=lambda r: 5e-2 * lr)

    mask = torch.tensor(r["action_mask"][0])  # (E, N, A)
    obs = torch.tensor(r["obs"][0])
    _, acts = model.policy()(None, obs.repeat(500, 1, 1), mask.repeat(500, 1, 1), torch.Generator().manual_seed(0))
    assert bool((mask.repeat(500, 1, 1).gather(-1, acts.unsqueeze(-1)) == 1).all())
