"""The port's bf16 model dtype against the JAX package's, on the same params
and numpy inputs: the mixed-precision product, the GRU layer, the MLP, GRU
and LSTM networks, the QMIX double-Q loss and gradients, and a whole PPO
update.

bf16 here is the JAX package's mixed precision: matmul inputs rounded to
bf16, products summed in f32, f32 results; the GRU kernels' recurrence in
f32. The port's kernel route (`fused_rnn` "auto"/"on" at H % 128 == 0) is
JAX's `fused_rnn="on"` ("interpret" on the CPU), with `gh` in f32; the
port's "off" is JAX's "off", with `gh` from bf16 inputs.

Tolerances: both sides round the same f32 values to bf16, so most results
agree to f32 round-off. Where a sum is taken in another order, its f32
result can round to the other neighbouring bf16 value at the next product,
one bf16 ulp (2^-8 of the entry) apart; those flips set the tolerances
stated at each assertion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from codebase_tpu.algos.ac import ACModel as JaxACModel
from codebase_tpu.algos.common import make_optimizer as jax_make_optimizer
from codebase_tpu.algos.dqn import DQNModel as JaxDQNModel
from codebase_tpu.config import Config as JaxConfig
from codebase_tpu.envs.lbforaging import parse_lbf_name as jax_parse_lbf_name
from codebase_tpu.models.multi_agent import MultiAgentNetwork as JaxMultiAgentNetwork
from codebase_tpu.models.networks import gru_layer_init as jax_gru_layer_init
from codebase_tpu.ops import fused_gru as jfg
from codebase_tpu_torch.algos.ac import ACModel, ACTrainState, build_train_functions
from codebase_tpu_torch.algos.common import Adam
from codebase_tpu_torch.algos.dqn import DQNModel
from codebase_tpu_torch.config import Config, load_config
from codebase_tpu_torch.envs.lbforaging import parse_lbf_name
from codebase_tpu_torch.envs.vector import Rollout
from codebase_tpu_torch.models.multi_agent import MultiAgentNetwork
from codebase_tpu_torch.models.networks import make_network_spec
from codebase_tpu_torch.ops import fused_gru as fg
from codebase_tpu_torch.ops.matmul import grouped_matmul
from codebase_tpu_torch.utils.params import params_from_numpy, tree_leaves

torch.set_num_threads(2)
BF16 = "bfloat16"


def _close_leaves(got, ref, frac, msg=""):
    """Each leaf within `frac` of its largest entry."""
    got, ref = list(got), tree_leaves(jax.device_get(ref))
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.detach().numpy(), r, rtol=0, atol=frac * max(np.abs(r).max(), 1e-30),
                                   err_msg=f"{msg} leaf {i}")


def test_bf16_product_is_jax_dot_general_with_f32_result():
    """Values: the same exact products summed in f32 (1e-6). Gradients: JAX
    forms each cotangent in f32 and rounds it to bf16, the cast input's
    dtype; the port does the same, so they agree bit for bit here."""
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal((3, 9, 40)).astype(np.float32), rng.standard_normal((3, 40, 6)).astype(np.float32)
    g = rng.standard_normal((3, 9, 6)).astype(np.float32)

    def jf(x, w):
        y = jax.lax.dot_general(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16), (((2,), (1,)), ((0,), (0,))),
                                preferred_element_type=jnp.float32)
        return jnp.sum(y * g), y

    (_, y_ref), (dx_ref, dw_ref) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(x, w)
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    y = grouped_matmul(tx, tw, BF16)
    assert y.dtype == torch.float32
    dx, dw = torch.autograd.grad((y * torch.tensor(g)).sum(), (tx, tw))
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(dx.numpy(), dx_ref)
    np.testing.assert_array_equal(dw.numpy(), dw_ref)
    # never rounded to bf16: not every entry of the result is a bf16 value
    assert not torch.equal(y, y.bfloat16().float())


def test_gru_layer_input_projection_in_bf16_matches_jax():
    """The GRU layer at bf16: gi from bf16 inputs with an f32 result, the
    recurrence in f32, against the JAX layer with its kernel in interpret
    mode (1e-5: only f32 sum order differs)."""
    G, T, B, Hh = 2, 4, 16, 128
    keys = jax.random.split(jax.random.PRNGKey(5), G)
    jparams = jax.vmap(lambda k: jax_gru_layer_init(k, Hh, Hh))(keys)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((G, T, B, Hh)).astype(np.float32)
    h0 = rng.standard_normal((G, B, Hh)).astype(np.float32)
    y_ref, hT_ref = jax.vmap(lambda p, xx, hh: jfg.gru_layer_sequence(p, xx, hh, BF16, interpret=True))(
        jparams, jnp.asarray(x), jnp.asarray(h0))
    y, hT = fg.gru_layer_sequence(params_from_numpy(jax.device_get(jparams)), torch.tensor(x), torch.tensor(h0), BF16)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), hT_ref, rtol=1e-5, atol=1e-5)


# the port's mode and its JAX counterpart
CASES = {
    "mlp": (False, "auto", "auto"),
    "gru_off": (True, "off", "off"),
    "gru_kernel_route": (True, "auto", "interpret"),
    "lstm": ("lstm", "auto", "auto"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_networks_in_bf16_match_jax(case):
    """Outputs within 2e-4 of the largest; gradients within 5e-4 of each
    leaf's largest entry, the LSTM's 1e-2 (its eight bf16 products a step
    round the cotangents of c at every step, where a flip is 2^-8)."""
    use_rnn, mode, jmode = CASES[case]
    N, T, B, D, A = 3, 5, 6, 7, 4
    kw = dict(input_sizes=[D] * N, hidden_dims=[128, 128], output_sizes=[A] * N, parameter_sharing=True,
              use_rnn=use_rnn)
    jnet = JaxMultiAgentNetwork.create(fused_rnn=jmode, compute_dtype=BF16, **kw)
    jparams = jax.jit(jnet.init)(jax.random.PRNGKey(0))
    net = MultiAgentNetwork(fused_rnn=mode, compute_dtype=BF16, **kw)
    net.load_params(params_from_numpy(jax.device_get(jparams)))
    if use_rnn:
        assert net.spec.route == ("kernel_resident" if case == "gru_kernel_route" else "cell")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, T, B, D)).astype(np.float32)
    w = rng.standard_normal((N, T, B, A)).astype(np.float32)

    def jloss(p):
        y, _ = jnet.apply(p, jnp.asarray(x))
        return jnp.sum(y * w), y

    (_, y_ref), g_ref = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    y, _ = net(torch.tensor(x))
    grads = torch.autograd.grad((y * torch.tensor(w)).sum(), tree_leaves(net.param_tree()))
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=0, atol=2e-4 * np.abs(y_ref).max())
    _close_leaves(grads, g_ref, 1e-2 if case == "lstm" else 5e-4, case)


def test_bf16_dtype_is_accepted_and_others_refused():
    assert make_network_spec((4, 8, 2), compute_dtype=BF16).compute_dtype == BF16
    with pytest.raises(ValueError, match="choose float32 or bfloat16"):
        make_network_spec((4, 8, 2), compute_dtype="float16")


ENV3 = "lbforaging:Foraging-8x8-3p-3f-v3"


def test_qmix_double_q_loss_and_grads_in_bf16_match_jax():
    """QMIX with the shared recurrent critic in bf16 (the mixer in f32, as
    the JAX package keeps it): loss within 1e-4, gradients within 4e-3 of
    each leaf's largest entry, one bf16 ulp of it (a cotangent rounded to
    bf16 on the other side of a tie moves by 2^-8 of itself)."""
    model_cfg = dict(name="qmix", layers=[128, 128], parameter_sharing=True, use_orthogonal_init=True,
                     use_rnn=True, dtype=BF16, mixing=dict(embed_dim=32, hypernet_layers=2, hypernet_embed=64))
    algo = dict(gamma=0.99, double_q=True, standardise_returns=False)
    jmodel = JaxDQNModel.create(jax_parse_lbf_name(ENV3), JaxConfig({**model_cfg, "fused_rnn": "interpret"}),
                                JaxConfig(algo))
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    tparams = jax.jit(jmodel.init_params)(jax.random.PRNGKey(1))
    model, target = (DQNModel.create(parse_lbf_name(ENV3), Config(model_cfg), Config(algo)) for _ in range(2))
    model.load_params(jax.device_get(params))
    target.load_params(jax.device_get(tparams))
    assert model.critic.spec.compute_dtype == BF16 and model.critic.spec.route == "kernel_resident"
    N, T, B, D, A = 3, 5, 8, 18, 6
    rng = np.random.default_rng(4)
    lengths = rng.integers(1, T + 1, size=B)
    batch = dict(
        obss=rng.integers(-1, 8, size=(N, T + 1, B, D)).astype(np.float32),
        actions=rng.integers(0, A, size=(N, T, B)).astype(np.int32),
        rewards=(rng.random((N, T, B)) * (rng.random((N, T, B)) < 0.3)).astype(np.float32),
        dones=np.concatenate([np.zeros((1, B)), (np.arange(T)[:, None] == lengths[None] - 1)], 0).astype(np.float32),
        filled=(np.arange(T)[:, None] < lengths[None]).astype(np.float32),
        action_mask=None,
    )
    jbatch = {k: (jnp.asarray(v) if v is not None else None) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, tparams, jbatch, jmodel.init_rms()), has_aux=True))(params)
    tbatch = {k: (torch.tensor(v) if v is not None else None) for k, v in batch.items()}
    tbatch["actions"] = tbatch["actions"].long()
    loss, _ = model.loss(target, tbatch, model.init_rms())
    grads = torch.autograd.grad(loss, model.param_leaves())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    _close_leaves(grads, jgrads, 4e-3, "qmix")


def test_ppo_update_in_bf16_matches_jax():
    """One whole MAPPO update (4 epochs, an Adam step each) with the
    recurrent actor and centralised recurrent critic in bf16: metrics
    within 1e-4, parameters within 0.1 * lr (Adam turns a gradient entry
    that a bf16 flip moves near zero into a step of up to lr)."""
    N, T, E, OBS, A = 2, 5, 8, 15, 6
    env_name = "lbforaging:Foraging-8x8-2p-3f-v3"
    lr = 1e-3
    net = dict(layers=[128, 128], parameter_sharing=True, use_orthogonal_init=True, use_rnn=True, dtype=BF16)
    model_cfg = dict(name="ppo", actor=net, critic={**net, "centralised": True})
    algo = dict(gamma=0.99, n_steps=3, entropy_coef=0.01, value_loss_coef=0.5, standardise_returns=False,
                num_epochs=4, ppo_clip=0.2)
    jcfg = {**model_cfg, "actor": {**net, "fused_rnn": "interpret"},
            "critic": {**model_cfg["critic"], "fused_rnn": "interpret"}}
    jmodel = JaxACModel.create(jax_parse_lbf_name(env_name), JaxConfig(jcfg), JaxConfig(algo))
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(13))
    model = ACModel.create(parse_lbf_name(env_name), Config(model_cfg), Config(algo))
    model.load_params(jax.device_get(params))
    assert model.actor.spec.compute_dtype == model.critic.spec.compute_dtype == BF16
    target = ACModel.create(parse_lbf_name(env_name), Config(model_cfg), Config(algo)).critic.requires_grad_(False)
    target.load_params(params_from_numpy(jax.device_get(params["critic"])))
    argv = ["+algorithm=mappo", f"algorithm.lr={lr}", "algorithm.model.actor.dtype=bfloat16",
            "algorithm.model.critic.dtype=bfloat16", "algorithm.model.actor.use_rnn=true",
            "algorithm.model.critic.use_rnn=true"]
    cfg = load_config(argv)
    cfg.algorithm.parallel_envs = E
    env = parse_lbf_name(env_name)
    update = build_train_functions(env, env, cfg.algorithm, T, torch.device("cpu"))[3]
    state = ACTrainState(model=model, target_critic=target, opt=Adam(model.param_leaves(), lr),
                         generator=torch.Generator().manual_seed(0), ret_rms=model.init_rms())

    rng = np.random.default_rng(30)
    lengths = rng.integers(1, T + 1, size=E)
    lengths[0] = T
    filled = (np.arange(T)[:, None] < lengths[None]).astype(np.float32)
    r = dict(obs=rng.integers(-1, 8, size=(T + 1, E, N, OBS)).astype(np.float32),
             actions=rng.integers(0, A, size=(T, E, N)),
             rewards=(rng.random((T, E, N)) * (rng.random((T, E, N)) < 0.4) * filled[..., None]).astype(np.float32),
             dones=np.concatenate([np.zeros((1, E)), np.arange(T)[:, None] == lengths[None] - 1]).astype(np.float32),
             filled=filled, action_mask=np.ones((T + 1, E, N, A), np.float32))
    obs_agents, amask = jnp.moveaxis(jnp.asarray(r["obs"]), 2, 0), jnp.moveaxis(jnp.asarray(r["action_mask"]), 2, 0)
    actions, rewards, dones = jnp.asarray(r["actions"], jnp.int32), jnp.asarray(r["rewards"]), jnp.asarray(r["dones"])
    opt = jax_make_optimizer("adam", lr, False)
    opt_state = opt.init(params)
    returns, _ = jmodel.compute_returns(params["critic"], obs_agents, rewards, dones, jmodel.init_rms())
    obs_in, amask_in = obs_agents[:, :-1], amask[:, :-1]
    old, _ = jmodel.log_probs_entropy(params["actor"], obs_in, actions, amask_in)
    grad_fn = jax.jit(jax.value_and_grad(jmodel.ppo_loss, has_aux=True))
    epochs = []
    for _ in range(4):
        (_, jm), grads = grad_fn(params, returns, old, obs_in, actions, amask_in, jnp.asarray(filled))
        upd, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
        epochs.append(jm)

    t = {k: torch.tensor(v) for k, v in r.items()}
    metrics = update(state, Rollout(obs=t["obs"], actions=t["actions"].long(), rewards=t["rewards"],
                                    stat_rewards=t["rewards"], dones=t["dones"], filled=t["filled"],
                                    action_mask=t["action_mask"]))
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), np.mean([float(e[k]) for e in epochs]), rtol=1e-4, atol=1e-6, err_msg=k)
    ref = tree_leaves(jax.device_get(params))
    for i, (g, p) in enumerate(zip(model.param_leaves(), ref)):
        np.testing.assert_allclose(g.detach().numpy(), p, rtol=0, atol=0.1 * lr, err_msg=f"leaf {i}")
