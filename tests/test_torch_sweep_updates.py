"""The units of a sweep in one train state against `jax.vmap` over the JAX
package's update, whose per-unit hyperparameters come from its
`dynamic_hypers` (the state `init_state(key, hyper)` makes, the lr
injected into the optimizer state).

Three units with distinct seeds, lr, gamma and tau, in the hard-copy and
in the Polyak regime, on injected per-unit batches (rollouts for the
actor-critic family): IDQN with the MLP and the GRU critic, VDN (shared
MLP), QMIX (shared GRU, return standardisation), IA2C (MLP) and MAPPO
(recurrent actor and centralised recurrent critic). The global-norm clip
binds in some units and not in another. Per unit: the loss, the
gradients (of the first update, where both sides hold the same params;
an Adam step moves a cancelled entry by an amount its last digits
decide, see below), the params after each Adam step, the target after its
maintenance, the return moments and the counters. The JAX update is
composed from the JAX package's parts as its `make_update_step` (value
family) and `update` (actor-critic family) compose them; its GRU runs its
CPU path. Tolerances are the single-unit parity tests': rtol 2e-4 on
everything (the IDQN tolerance of ROADMAP.md), gradients with atol 1e-6 of
the leaf's scale, params and targets with atol 5e-2 * lr (an entry whose
gradient cancels to ~1e-7 keeps only its leading digits in f32, and Adam
turns that into a step of up to lr in either package); an entry whose
gradient agreed only to that absolute tolerance (it cancelled to below
1e-6 of its leaf's scale: Adam's step g / (|g| + 1e-8) then depends on
its last digits, and its sign may differ) has 2 * lr more room for each
such step. The recurrent
MAPPO takes one PPO epoch in f32; several epochs run in float64 on both
sides (MAPPO with MLPs: the JAX GRU runs in f32 only), to rtol 1e-9, as
the single-unit PPO test does (the clip boundary amplifies f32 round-off
over epochs), with hyperparameters that f32 holds exactly (the JAX
package keeps its traced hyperparameters in f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from codebase_tpu.algos import ac as jax_ac
from codebase_tpu.algos import dqn as jax_dqn
from codebase_tpu.algos.common import make_optimizer as jax_make_optimizer
from codebase_tpu.algos.common import soft_update as jax_soft_update
from codebase_tpu.algos.common import tree_where
from codebase_tpu.config import load_config as jax_load_config
from codebase_tpu.envs.lbforaging import parse_lbf_name as jax_parse_lbf_name
from codebase_tpu_torch.algos import ac, dqn
from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.envs.lbforaging import parse_lbf_name
from codebase_tpu_torch.envs.vector import Rollout
from codebase_tpu_torch.utils.params import tree_leaves

torch.set_num_threads(2)
CPU = torch.device("cpu")
U, T, B = 3, 5, 6
SEEDS = [0, 1, 2]
LRS = [1e-3, 3e-3, 5e-4]
GAMMAS = [0.99, 0.9, 0.5]
REGIMES = {  # config default, per-unit taus
    "hard": (200, [2, 3, 5]),
    "polyak": (0.05, [0.01, 0.1, 0.5]),
}
ENVS = {2: "lbforaging:Foraging-8x8-2p-3f-v3", 3: "lbforaging:Foraging-8x8-3p-2f-v3"}
DQN_FAMILIES = {
    "idqn_mlp": (2, ["+algorithm=idqn", "algorithm.model.layers=[16,16]"]),
    "idqn_gru": (2, ["+algorithm=idqn", "algorithm.model.use_rnn=true"]),
    "vdn": (3, ["+algorithm=vdn", "algorithm.model.layers=[16,16]", "algorithm.model.parameter_sharing=true"]),
    "qmix_std": (3, ["+algorithm=qmix", "algorithm.model.use_rnn=true", "algorithm.model.parameter_sharing=true",
                     "algorithm.standardise_returns=true", "algorithm.model.mixing.embed_dim=8",
                     "algorithm.model.mixing.hypernet_embed=16"]),
}
AC_FAMILIES = {  # argv, float64
    "ia2c": (["+algorithm=ia2c", "algorithm.model.actor.layers=[16,16]", "algorithm.model.critic.layers=[16,16]",
              "algorithm.n_steps=3"], False),
    "mappo_gru": (["+algorithm=mappo", "algorithm.model.actor.use_rnn=true", "algorithm.model.critic.use_rnn=true",
                   "algorithm.num_epochs=1"], False),
    # the epochs in float64 (the JAX GRU runs in f32 only: an MLP here)
    "mappo_mlp_f64": (["+algorithm=mappo", "algorithm.model.actor.layers=[16,16]",
                       "algorithm.model.critic.layers=[16,16]", "algorithm.num_epochs=2"], True),
}
# hyperparameters f32 holds exactly, for the float64 comparison
LRS_64, GAMMAS_64 = [2.0**-10, 2.0**-8, 2.0**-11], [0.5, 0.75, 0.875]


def _hypers(taus, exact=False):
    lrs, gammas = (LRS_64, GAMMAS_64) if exact else (LRS, GAMMAS)
    return [{"lr": lr, "gamma": g, "tau": float(t)} for lr, g, t in zip(lrs, gammas, taus)]


def _jax_states(jbuild, taus, exact=False):
    """The JAX package's per-unit states, vmapped over `init_state(key,
    hyper)` as its sweep makes them."""
    hyper = {k: np.asarray([h[k] for h in _hypers(taus, exact)], np.float32) for k in ("lr", "gamma", "tau")}
    keys = jax.vmap(jax.random.PRNGKey)(np.asarray(SEEDS, np.uint32))
    return jax.vmap(jbuild)(keys, hyper)


def _load(port_leaves, jax_tree):
    """Unit-stacked JAX leaves (U, ...) into the port's unit-major leaves."""
    ref = tree_leaves(jax.device_get(jax_tree))
    assert len(ref) == len(port_leaves)
    with torch.no_grad():
        for p, r in zip(port_leaves, ref):
            p.copy_(torch.tensor(np.asarray(r)).reshape(p.shape))


def _per_unit(port_leaves, jax_tree, atol, rtol=2e-4, msg=""):
    ref = tree_leaves(jax.device_get(jax_tree))
    for i, (p, r) in enumerate(zip(port_leaves, ref)):
        got, r = p.detach().reshape(U, -1).numpy(), np.asarray(r).reshape(U, -1)
        for u in range(U):
            np.testing.assert_allclose(got[u], r[u], rtol=rtol, atol=atol(r[u]), err_msg=f"{msg} leaf {i} unit {u}")


def _grad_atol(r):
    return 1e-6 * max(1.0, np.abs(r).max())


class _StepRoom:
    """Per-entry room of the params after Adam steps: 2 * lr of the unit
    for every step whose reference gradient at the entry was within the
    gradients' absolute tolerance (see the module docstring)."""

    def __init__(self, lrs):
        self.lrs, self.room = np.asarray(lrs), None

    def add(self, jax_grads):
        ref = [np.asarray(r).reshape(U, -1) for r in tree_leaves(jax.device_get(jax_grads))]
        cancelled = [np.stack([np.abs(r[u]) <= _grad_atol(r[u]) for u in range(U)]) for r in ref]
        step = [2.0 * self.lrs[:, None] * c for c in cancelled]
        self.room = step if self.room is None else [a + b for a, b in zip(self.room, step)]

    def check(self, port_leaves, jax_tree, msg, first=0):
        """`first`: the index of the leaves' first entry among the
        gradient's leaves (the target critic's are the critic's)."""
        ref = tree_leaves(jax.device_get(jax_tree))
        assert len(ref) == len(port_leaves) <= len(self.room) - first
        for i, (p, r, room) in enumerate(zip(port_leaves, ref, self.room[first:])):
            got, r = p.detach().reshape(U, -1).numpy(), np.asarray(r).reshape(U, -1)
            bad = np.abs(got - r) > 5e-2 * self.lrs[:, None] + room + 2e-4 * np.abs(r)
            assert not bad.any(), (f"{msg} leaf {i}: units {np.nonzero(bad.any(1))[0].tolist()}, "
                                   f"max diff {np.abs(got - r)[bad].max()}")


def _clip_between(norms):
    """A clip bound in the widest gap between the units' gradient norms:
    it binds in the units above it and not in those below."""
    ordered = sorted(float(n) for n in norms)
    lo, hi = max(zip(ordered, ordered[1:]), key=lambda p: p[1] / p[0])
    assert hi > 1.05 * lo, norms
    return float(np.sqrt(lo * hi))


# ---------------------------------------------------------- value family


def _dqn_batch(seed, N, D=15, A=6):
    """One reference-layout batch per unit, stacked: obss (U, N, T+1, B, D)..."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, size=(U, B))
    filled = (np.arange(T)[None, :, None] < lengths[:, None]).astype(np.float32)
    dones = np.concatenate([np.zeros((U, 1, B)), np.arange(T)[None, :, None] == lengths[:, None] - 1], 1)
    return dict(
        obss=rng.integers(-1, 8, size=(U, N, T + 1, B, D)).astype(np.float32),
        actions=rng.integers(0, A, size=(U, N, T, B)).astype(np.int32),
        rewards=(rng.random((U, N, T, B)) * (rng.random((U, N, T, B)) < 0.4)).astype(np.float32),
        dones=dones.astype(np.float32),
        filled=filled,
    )


def _fold_dqn(b):
    """The port's layout: agents of all units on one axis, dones and filled
    with a leading unit axis."""
    t = {k: torch.tensor(v) for k, v in b.items()}
    out = {k: t[k].reshape((-1,) + t[k].shape[2:]) for k in ("obss", "actions", "rewards")}
    out["actions"] = out["actions"].long()
    return {**out, "dones": t["dones"], "filled": t["filled"], "action_mask": None}


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("family", sorted(DQN_FAMILIES))
def test_value_family_units_match_the_vmapped_jax_update(family, regime):
    N, argv = DQN_FAMILIES[family]
    default_tau, taus = REGIMES[regime]
    argv = argv + [f"algorithm.target_update_interval_or_tau={default_tau}", f"algorithm.batch_size={B}",
                   "algorithm.buffer_size=16", "algorithm.parallel_envs=4", "device=cpu"]
    jcfg, cfg = jax_load_config(argv).algorithm, load_config(argv).algorithm
    jenv, env = jax_parse_lbf_name(ENVS[N]), parse_lbf_name(ENVS[N])
    jmodel, jinit, _, _ = jax_dqn.build_train_functions(jenv, jenv, jcfg, T, dynamic_hypers=("lr", "gamma", "tau"))
    states = _jax_states(jinit, taus)
    batches = [_dqn_batch(10 + k, N) for k in range(3)]
    clip_mask = {"critic": True, "mixer": False} if jmodel.mixer is not None else None

    # the clip: between the units' (critic) gradient norms of update 1
    def loss_grads(p, tp, b, rms, gamma):
        return jax.value_and_grad(jmodel.loss, has_aux=True)(p, tp, b, rms, gamma)

    _, g1 = jax.vmap(loss_grads)(states.params, states.target_params,
                                 {**jax.tree.map(jnp.asarray, batches[0]), "action_mask": None},
                                 states.ret_rms, states.hyper["gamma"])
    norms = np.asarray(jax.vmap(optax.global_norm)(g1["critic"]))
    clip = _clip_between(norms)
    opt = jax_make_optimizer(jcfg.optimizer, LRS[0], clip, inject_lr=True, clip_mask=clip_mask)

    def jax_update(carry, hyper, batch):  # as `make_update_step` composes it
        params, tparams, opt_state, rms, updates, last = carry
        (loss, rms), grads = jax.value_and_grad(jmodel.loss, has_aux=True)(params, tparams, batch, rms, hyper["gamma"])
        upd, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
        updates = updates + 1
        if default_tau > 1.0:
            do_hard = (updates - last) >= hyper["tau"]
            tparams = tree_where(do_hard, params, tparams)
            last = jnp.where(do_hard, updates, last)
        else:
            tparams = jax_soft_update(tparams, params, hyper["tau"])
        return (params, tparams, opt_state, rms, updates, last), loss, grads

    vupdate = jax.jit(jax.vmap(jax_update))
    carry = (states.params, states.target_params, states.opt_state, states.ret_rms, states.updates,
             states.last_target_update)

    cfg.grad_clip = clip
    init_state, train_iteration, _ = dqn.build_train_functions(env, env, cfg, T, CPU, hypers=_hypers(taus))
    state = init_state(SEEDS)
    _load(state.model.param_leaves(), states.params)
    _load(state.target.param_leaves(), states.target_params)
    assert state.model.n_units == U and state.buffer.obs.shape[0] == U * 16
    room = _StepRoom(LRS)
    for k, b in enumerate(batches):
        jb = {**jax.tree.map(jnp.asarray, b), "action_mask": None}
        carry, jloss, jgrads = vupdate(carry, states.hyper, jb)
        pb = _fold_dqn(b)
        losses, _ = state.model.unit_losses(state.target, pb, state.ret_rms)
        grads = torch.autograd.grad(losses.sum(), state.model.param_leaves())
        got = train_iteration.update(state, pb)
        np.testing.assert_allclose(got.numpy(), np.asarray(jloss), rtol=2e-4, err_msg=f"loss {k}")
        np.testing.assert_allclose(losses.detach().numpy(), np.asarray(jloss), rtol=2e-4)
        if k == 0:
            _per_unit(grads, jgrads, _grad_atol, msg=f"grads {k}")
        room.add(jgrads)
        params, tparams, _, rms, updates, last = carry
        room.check(state.model.param_leaves(), params, f"params {k}")
        room.check(state.target.param_leaves(), tparams, f"target {k}")
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(state.ret_rms, f).numpy(), np.asarray(getattr(rms, f)), rtol=2e-4)
        assert state.updates.tolist() == np.asarray(updates).tolist() == [k + 1] * U
        assert state.last_target_update.tolist() == np.asarray(last).tolist()
        assert state.opt.count.tolist() == [k + 1] * U
    if regime == "hard":  # the units copied at updates 2 and 3 and never
        assert state.last_target_update.tolist() == [2, 3, 0]


# ------------------------------------------------------ actor-critic family
N2, E, OBS, A = 2, 4, 15, 6


def _ac_rollout(seed):
    """One numpy rollout per unit, stacked: obs (U, T+1, E, N, D), ..."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, size=(U, E))
    lengths[:, 0] = T
    filled = (np.arange(T)[None, :, None] < lengths[:, None]).astype(np.float32)
    return dict(
        obs=rng.integers(-1, 8, size=(U, T + 1, E, N2, OBS)).astype(np.float32),
        actions=rng.integers(0, A, size=(U, T, E, N2)),
        rewards=(rng.random((U, T, E, N2)) * (rng.random((U, T, E, N2)) < 0.4) * filled[..., None]).astype(np.float32),
        dones=np.concatenate([np.zeros((U, 1, E)), np.arange(T)[None, :, None] == lengths[:, None] - 1], 1).astype(np.float32),
        filled=filled,
        action_mask=np.ones((U, T + 1, E, N2, A), np.float32),
    )


def _jax_ac_inputs(r):
    mv = lambda x: jnp.moveaxis(jnp.asarray(x), 3, 1)  # noqa: E731  (U, T', E, N, ...) -> (U, N, T', E, ...)
    return (mv(r["obs"]), mv(r["action_mask"]), jnp.asarray(r["actions"], jnp.int32), jnp.asarray(r["rewards"]),
            jnp.asarray(r["dones"]), jnp.asarray(r["filled"]))


def _port_rollout(r):
    """The collector's layout with the units' envs unit-major: (T', U*E, ...)."""
    t = {k: torch.tensor(v).transpose(0, 1) for k, v in r.items()}
    t = {k: v.reshape(v.shape[:1] + (-1,) + v.shape[3:]) for k, v in t.items()}
    return Rollout(obs=t["obs"], actions=t["actions"].long(), rewards=t["rewards"], stat_rewards=t["rewards"],
                   dones=t["dones"], filled=t["filled"], action_mask=t["action_mask"])


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("family", sorted(AC_FAMILIES))
def test_actor_critic_units_match_the_vmapped_jax_update(family, regime):
    argv, f64 = AC_FAMILIES[family]
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", f64)
    try:
        _actor_critic_parity(argv, f64, regime)
    finally:
        jax.config.update("jax_enable_x64", x64)


def _to64(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _actor_critic_parity(argv, f64, regime):
    default_tau, taus = REGIMES[regime]
    if regime == "hard":  # env-step counts and intervals: refreshes at different updates
        taus = [40, 80, 30]
    elif f64:
        taus = [0.5, 0.25, 0.125]
    steps0 = np.array([0, 40, 60])
    lrs = LRS_64 if f64 else LRS
    dtype = np.float64 if f64 else np.float32
    rtol = 1e-9 if f64 else 2e-4
    grad_atol = (lambda r: 1e-12 * max(1.0, np.abs(r).max())) if f64 else _grad_atol
    argv = argv + [f"algorithm.target_update_interval_or_tau={default_tau}", "device=cpu"]
    jcfg, cfg = jax_load_config(argv).algorithm, load_config(argv).algorithm
    jenv, env = jax_parse_lbf_name(ENVS[2]), parse_lbf_name(ENVS[2])
    jcfg.parallel_envs = cfg.parallel_envs = E
    jcfg.grad_clip = 1.0  # a clip in the optimizer state's chain; its bound is chosen below
    jmodel, jinit, _, _ = jax_ac.build_train_functions(jenv, jenv, jcfg, T, dynamic_hypers=("lr", "gamma", "tau"))
    states = _jax_states(jinit, taus, exact=f64)
    rollouts = [{k: v.astype(dtype) if v.dtype.kind == "f" else v for k, v in _ac_rollout(20 + k).items()}
                for k in range(2)]
    params, tcritic, opt_state, rms = states.params, states.target_critic, states.opt_state, states.ret_rms
    if f64:
        params, tcritic, opt_state = _to64(params), _to64(tcritic), _to64(opt_state)

    def first_grads(params, tcritic, rms, gamma, r):
        """The loss and gradients of the first step (the A2C step, or PPO's
        first epoch, whose ratio is 1)."""
        obs_agents, amask, actions, rewards, dones, filled = r
        returns, _ = jmodel.compute_returns(tcritic, obs_agents, rewards, dones, rms, gamma)
        returns = jax.lax.stop_gradient(returns)
        args = (obs_agents[:, :-1], actions, amask[:, :-1], filled)
        if not jmodel.ppo:
            return jax.value_and_grad(jmodel.a2c_loss, has_aux=True)(params, returns, *args)
        old, _ = jmodel.log_probs_entropy(params["actor"], obs_agents[:, :-1], actions, amask[:, :-1])
        return jax.value_and_grad(jmodel.ppo_loss, has_aux=True)(params, returns, jax.lax.stop_gradient(old), *args)

    (_, _), g1 = jax.vmap(first_grads)(params, tcritic, rms, states.hyper["gamma"], _jax_ac_inputs(rollouts[0]))
    clip = _clip_between(np.asarray(jax.vmap(optax.global_norm)(g1)))
    opt = jax_make_optimizer(jcfg.optimizer, lrs[0], clip, inject_lr=True)

    def jax_update(params, tcritic, opt_state, rms, env_steps, hyper, r):  # as the JAX `update` composes it
        obs_agents, amask, actions, rewards, dones, filled = r
        returns, rms = jmodel.compute_returns(tcritic, obs_agents, rewards, dones, rms, hyper["gamma"])
        returns = jax.lax.stop_gradient(returns)
        obs_in, amask_in = obs_agents[:, :-1], amask[:, :-1]
        if not jmodel.ppo:
            (_, metrics), grads = jax.value_and_grad(jmodel.a2c_loss, has_aux=True)(
                params, returns, obs_in, actions, amask_in, filled)
            upd, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, upd)
        else:
            old = jax.lax.stop_gradient(jmodel.log_probs_entropy(params["actor"], obs_in, actions, amask_in)[0])

            def epoch(c, _):
                p, s = c
                (_, m), g = jax.value_and_grad(jmodel.ppo_loss, has_aux=True)(
                    p, returns, old, obs_in, actions, amask_in, filled)
                u, s = opt.update(g, s, p)
                return (optax.apply_updates(p, u), s), m

            (params, opt_state), ms = jax.lax.scan(epoch, (params, opt_state), None, length=jmodel.num_epochs)
            metrics = jax.tree.map(jnp.mean, ms)
        if default_tau > 1.0:
            tcritic = tree_where((env_steps % hyper["tau"].astype(jnp.int32)) == 0, params["critic"], tcritic)
        else:
            tcritic = jax_soft_update(tcritic, params["critic"], hyper["tau"])
        return params, tcritic, opt_state, rms, metrics

    vupdate = jax.jit(jax.vmap(jax_update))

    cfg.grad_clip = clip
    init_state, _, _, update = ac.build_train_functions(env, env, cfg, T, CPU, hypers=_hypers(taus, exact=f64))
    state = init_state(SEEDS)
    if f64:
        state.model.double()
        state.target_critic.double()
        state.opt.mu = [torch.zeros_like(p) for p in state.opt.params]
        state.opt.nu = [torch.zeros_like(p) for p in state.opt.params]
    _load(state.model.param_leaves(), params)
    _load(state.target_critic.param_leaves(), tcritic)
    state.env_steps = steps0.copy()
    room = _StepRoom(lrs)
    for k, r in enumerate(rollouts):
        jr = _jax_ac_inputs(r)
        (jloss, _), jgrads = jax.vmap(first_grads)(params, tcritic, rms, states.hyper["gamma"], jr)
        params, tcritic, opt_state, rms, jm = vupdate(params, tcritic, opt_state, rms,
                                                      jnp.asarray(state.env_steps, jnp.int32), states.hyper, jr)
        pr = _port_rollout(r)
        model = state.model
        with torch.no_grad():
            obs_agents = pr.obs.reshape(T + 1, U, E, N2, OBS).permute(1, 3, 0, 2, 4).reshape(U * N2, T + 1, E, OBS)
            units = lambda x: x.reshape((x.shape[0], U, E) + x.shape[2:]).transpose(0, 1)  # noqa: E731
            returns, _ = model.compute_returns(state.target_critic, obs_agents, units(pr.rewards), units(pr.dones),
                                               state.ret_rms)
            old = model.log_probs_entropy(obs_agents[:, :-1], units(pr.actions))[0]
        fn = model.ppo_loss if model.ppo else model.a2c_loss
        extra = (old,) if model.ppo else ()
        loss, metrics0 = fn(returns, *extra, obs_agents[:, :-1], units(pr.actions), units(pr.filled))
        grads = torch.autograd.grad(loss, model.param_leaves())
        np.testing.assert_allclose(metrics0["loss"].numpy(), np.asarray(jloss), rtol=rtol, err_msg=f"loss {k}")
        if k == 0 or f64:
            _per_unit(grads, jgrads, grad_atol, rtol=rtol, msg=f"grads {k}")

        metrics = update(state, pr)
        for name in ("loss", "actor_loss", "value_loss", "entropy"):
            np.testing.assert_allclose(metrics[name].numpy(), np.asarray(jm[name]), rtol=rtol, atol=1e-6 if not f64 else 1e-12,
                                       err_msg=f"{name} {k}")
        if f64:  # as the single-unit PPO test holds them
            _per_unit(state.model.param_leaves(), params, lambda r: 1e-12, rtol=rtol, msg=f"params {k}")
            _per_unit(state.target_critic.param_leaves(), tcritic, lambda r: 1e-12, rtol=rtol, msg=f"target {k}")
        else:  # one Adam step an update (A2C, or PPO's one epoch)
            room.add(jgrads)
            room.check(state.model.param_leaves(), params, f"params {k}")
            room.check(state.target_critic.param_leaves(), tcritic, f"target {k}",
                       first=len(state.model.actor.param_leaves()))
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(state.ret_rms, f).numpy(), np.asarray(getattr(rms, f)), rtol=2e-4)
        assert state.updates.tolist() == [k + 1] * U and state.opt.count.tolist() == [(k + 1) * model.num_epochs] * U
        state.env_steps = state.env_steps + 40
