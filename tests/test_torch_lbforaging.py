"""The port's batched LBF against the JAX package's.

`step_batch` and the observations must match exactly on states made by the
JAX `reset_batch` and on numpy-drawn actions (the dynamics ignore the key).
Spawning draws different random numbers on each side, so the reset is held
to the JAX package by its marginal distributions. Grid observations
(`-grid` ids) are held to the JAX package's the same way.
"""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codebase_tpu.envs.lbforaging import parse_lbf_name as jax_parse_lbf_name
from codebase_tpu_torch.envs.lbforaging import LBFBatchState, parse_lbf_name

torch.set_num_threads(2)
NAMES = [
    "lbforaging:Foraging-8x8-2p-3f-v3",
    "lbforaging:Foraging-2s-8x8-3p-2f-coop-v3",
    "lbforaging:Foraging-5x5-2p-1f-v3",
]
# action mix weighted towards LOAD so that foods get collected
P_ACTIONS = [0.1, 0.12, 0.12, 0.12, 0.12, 0.42]


def to_torch_state(js) -> LBFBatchState:
    return LBFBatchState(**{f.name: torch.as_tensor(np.array(getattr(js, f.name))) for f in fields(LBFBatchState)})


def assert_state_equal(js, ts):
    for f in fields(LBFBatchState):
        np.testing.assert_array_equal(getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name)), err_msg=f.name)


@pytest.mark.parametrize("name", NAMES)
def test_step_and_obs_match_jax_exactly(name):
    E, steps = 64, 25
    jenv, env = jax_parse_lbf_name(name), parse_lbf_name(name)
    assert env.obs_dim == jenv.obs_dim and env.n_actions == jenv.n_actions
    jstate, jts = jax.jit(jenv.reset_batch, static_argnums=1)(jax.random.PRNGKey(0), E)
    state = to_torch_state(jstate)
    np.testing.assert_array_equal(env._make_obs_batch(state).numpy(), np.asarray(jts.obs))
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(2)
    jax_step = jax.jit(jenv.step_batch)
    collected = 0
    for _ in range(steps):
        a = rng.choice(6, size=(E, env.n_agents), p=P_ACTIONS)
        jstate, jts = jax_step(jstate, jnp.asarray(a, jnp.int32), key)
        state, ts = env.step_batch(state, torch.as_tensor(a))
        assert_state_equal(jstate, state)
        for field in ("obs", "reward", "stat_reward", "terminated", "truncated", "action_mask"):
            np.testing.assert_array_equal(
                getattr(ts, field).numpy(), np.asarray(getattr(jts, field)), err_msg=field
            )
        collected += int(np.asarray(jts.reward > 0).sum())
    if not env.force_coop:  # a coop food needs every player's level at once
        assert collected > 0, "no food was collected: the loading rules went untested"


def _tv(a, b, bins):
    pa = np.bincount(a, minlength=bins) / len(a)
    pb = np.bincount(b, minlength=bins) / len(b)
    return 0.5 * np.abs(pa - pb).sum()


def _marginals(state, cols):
    s = {f.name: np.asarray(getattr(state, f.name)) for f in fields(LBFBatchState)}
    active = s["food_active"].astype(bool)
    out = {f"agent{i}_cell": s["agent_r"][i] * cols + s["agent_c"][i] for i in range(s["agent_r"].shape[0])}
    out["agent_level"] = s["agent_level"].ravel()
    out["food_cell"] = (s["food_r"] * cols + s["food_c"])[active]
    out["food_level"] = s["food_level"][active]
    out["food_active_slots"] = np.nonzero(active)[0]
    out["n_active"] = active.sum(0)
    return out


@pytest.mark.parametrize("name", NAMES[:2])
def test_reset_spawn_marginals_match_jax(name):
    """Total-variation distance between the two packages' marginals over
    16384 resets each, bounded at 2.5x the distance expected between two
    samples of one distribution (two JAX seeds land at about 1x)."""
    E = 16384
    jenv, env = jax_parse_lbf_name(name), parse_lbf_name(name)
    jstate, _ = jax.jit(jenv.reset_batch, static_argnums=1)(jax.random.PRNGKey(7), E)
    state, ts = env.reset_batch(torch.Generator().manual_seed(7), E)
    np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(jax.jit(jenv._make_obs_batch)(_as_jax(state))))
    jm, tm = _marginals(jstate, env.cols), _marginals(state, env.cols)
    assert np.all(tm["agent_level"] >= env.min_player_level)
    assert np.all(tm["agent_level"] <= env.max_player_level)
    for k in jm:
        bins = int(max(jm[k].max(), tm[k].max())) + 1
        n = min(len(jm[k]), len(tm[k]))
        # two samples of one distribution sit about sqrt(bins / (pi n)) apart
        assert _tv(jm[k], tm[k], bins) < 2.5 * np.sqrt(bins / (np.pi * n)) + 0.005, k
    # the spawn rules themselves: distinct agent cells, interior food cells
    # with no food in the 8-neighbourhood and no agent on them
    ar, ac = state.agent_r.numpy(), state.agent_c.numpy()
    assert np.all(ar[0] * env.cols + ac[0] != ar[1] * env.cols + ac[1])
    fr, fc, act = state.food_r.numpy(), state.food_c.numpy(), state.food_active.numpy()
    assert np.all((fr[act] >= 1) & (fr[act] <= env.rows - 2) & (fc[act] >= 1) & (fc[act] <= env.cols - 2))
    for i in range(fr.shape[0]):
        for j in range(i + 1, fr.shape[0]):
            both = act[i] & act[j]
            assert np.all(np.maximum(np.abs(fr[i] - fr[j]), np.abs(fc[i] - fc[j]))[both] >= 2)


def _as_jax(state):
    from codebase_tpu.envs.lbforaging import LBFBatchState as JaxLBFBatchState

    return JaxLBFBatchState(**{f.name: jnp.asarray(getattr(state, f.name).numpy()) for f in fields(LBFBatchState)})


def test_parse_rejects_what_waits():
    """Grid observations (`-grid` ids), which this test once expected the
    parser to refuse, against the JAX package's: the JAX grid env steps its
    vmapped scalar step on an unbatched state; the port steps its batched
    state (the same state through the JAX `to_batch`) and builds the grid
    windows batched. Observations and rewards equal, step for step."""
    for name in ("lbforaging:Foraging-grid-8x8-2p-3f-v3", "Foraging-2s-8x8-3p-2f-grid-v3"):
        E, steps = 32, 25
        jenv, env = jax_parse_lbf_name(name), parse_lbf_name(name)
        assert env.grid_obs and (env.obs_dim, env.sight) == (jenv.obs_dim, jenv.sight)
        jstate, jts = jax.jit(jenv.reset_batch, static_argnums=1)(jax.random.PRNGKey(0), E)
        state = to_torch_state(jenv.to_batch(jstate))
        np.testing.assert_array_equal(env._make_obs_batch(state).numpy(), np.asarray(jts.obs))
        rng = np.random.default_rng(1)
        jax_step = jax.jit(jenv.step_batch)
        for t in range(steps):
            a = rng.choice(6, size=(E, env.n_agents), p=P_ACTIONS)
            jstate, jts = jax_step(jstate, jnp.asarray(a, jnp.int32), jax.random.PRNGKey(t))
            state, ts = env.step_batch(state, torch.as_tensor(a))
            assert_state_equal(jenv.to_batch(jstate), state)
            np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(jts.obs), err_msg=f"{name} step {t}")
            np.testing.assert_array_equal(ts.reward.numpy(), np.asarray(jts.reward))
    env = parse_lbf_name("Foraging-2s-8x8-3p-2f-coop-v3")
    assert (env.sight, env.num_agents, env.max_food, env.force_coop, env.grid_obs) == (2, 3, 2, True, False)
