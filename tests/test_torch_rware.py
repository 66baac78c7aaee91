"""The port's batched RWARE against the JAX package's.

`step_batch` and the observations must match exactly on states made by the
JAX `reset_batch`, with deliveries planted, on numpy-drawn actions. The one
random part of a step is the request drawn after a delivery: JAX keys and
torch's generator cannot draw the same shelf, so the lock-step test copies
the JAX package's requests into the port's state after each step (every
env that did not deliver must already agree), and the port's own draw is
held to its rules and to the uniform distribution. The reset is held to the
JAX package by its marginal distributions.
"""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codebase_tpu.envs.rware import RWAREBatchState as JaxRWAREBatchState
from codebase_tpu.envs.rware import parse_rware_name as jax_parse_rware_name
from codebase_tpu_torch.envs.rware import NOOP, SIZES, RWAREBatchState, parse_rware_name

torch.set_num_threads(2)
STATE_FIELDS = [f.name for f in fields(RWAREBatchState)]
NAMES = ["rware-tiny-2ag-v2", "rware:rware-small-4ag-v2", "rware-tiny-2ag-hard-v2"]
# FORWARD-heavy, with loads, so that shelves are picked up and put down
P_ACTIONS = [0.1, 0.4, 0.15, 0.15, 0.2]


def to_torch_state(arrays) -> RWAREBatchState:
    return RWAREBatchState(**{k: torch.as_tensor(np.array(arrays[k])) for k in STATE_FIELDS})


def to_jax_state(arrays) -> JaxRWAREBatchState:
    return JaxRWAREBatchState(**{k: jnp.asarray(arrays[k]) for k in STATE_FIELDS})


def plant_deliveries(env, arrays, envs):
    """In each env of `envs`, agent 0 stands on a goal cell carrying its
    env's first requested shelf; the other agents wait on the highway row
    above the goals, so the next step delivers. Returns new arrays."""
    a = {k: np.array(v) for k, v in arrays.items()}
    goal_r, goal_c = env.rows - 1, env.cols // 2 - 1
    for e in envs:
        s = int(np.flatnonzero(a["requested"][:, e])[0])
        a["agent_r"][0, e], a["agent_c"][0, e] = goal_r, goal_c
        a["agent_r"][1:, e] = env.rows - 2
        a["agent_c"][1:, e] = np.arange(env.num_agents - 1)
        a["carrying"][0, e] = s
        a["shelf_carried"][s, e] = True
        a["shelf_r"][s, e], a["shelf_c"][s, e] = goal_r, goal_c
    return a


def _arrays(js):
    return {k: np.asarray(getattr(js, k)) for k in STATE_FIELDS}


@pytest.mark.parametrize("name", NAMES)
def test_step_and_obs_match_jax_exactly(name):
    E, steps = 64, 60
    jenv, env = jax_parse_rware_name(name), parse_rware_name(name)
    for prop in ("rows", "cols", "n_shelves", "obs_dim", "n_actions", "request_queue_size"):
        assert getattr(env, prop) == getattr(jenv, prop), prop
    jstate, _ = jax.jit(jenv.reset_batch, static_argnums=1)(jax.random.PRNGKey(0), E)
    arrays = plant_deliveries(env, _arrays(jstate), range(0, E, 4))
    jstate, state = to_jax_state(arrays), to_torch_state(arrays)
    np.testing.assert_array_equal(env._make_obs_batch(state).numpy(), np.asarray(jenv._make_obs_batch(jstate)))
    rng = np.random.default_rng(1)
    jax_step = jax.jit(jenv.step_batch)
    gen = torch.Generator().manual_seed(0)
    deliveries = pickups = putdowns = 0
    for t in range(steps):
        a = rng.choice(5, size=(E, env.n_agents), p=P_ACTIONS)
        if t == 0:
            a[::4, 0] = NOOP  # the planted deliveries
        carried_before = state.shelf_carried.clone()
        jstate, jts = jax_step(jstate, jnp.asarray(a, jnp.int32), jax.random.PRNGKey(t))
        state, ts = env.step_batch(state, torch.as_tensor(a), gen)
        for k in STATE_FIELDS:
            if k != "requested":
                np.testing.assert_array_equal(getattr(state, k).numpy(), np.asarray(getattr(jstate, k)),
                                              err_msg=f"step {t} {k}")
        for k in ("reward", "stat_reward", "terminated", "truncated", "action_mask"):
            np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(jts, k)), err_msg=f"step {t} {k}")
        delivered = np.asarray(jts.reward).sum(1) > 0
        jreq = np.asarray(jstate.requested)
        np.testing.assert_array_equal(state.requested.numpy()[:, ~delivered], jreq[:, ~delivered])
        np.testing.assert_array_equal(state.requested.sum(0).numpy(), jreq.sum(0))  # the queue keeps its size
        state.requested = torch.as_tensor(jreq.copy())  # JAX's draw, so the obs below can be compared
        np.testing.assert_array_equal(env._make_obs_batch(state).numpy(), np.asarray(jts.obs), err_msg=f"step {t} obs")
        deliveries += int(delivered.sum())
        pickups += int((state.shelf_carried & ~carried_before).sum())
        putdowns += int((~state.shelf_carried & carried_before).sum())
    assert deliveries >= E // 4 and pickups > 0 and putdowns > 0, (deliveries, pickups, putdowns)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_storage_closed_form_matches_the_grid(size):
    env, jenv = parse_rware_name(f"rware-{size}-2ag-v2"), jax_parse_rware_name(f"rware-{size}-2ag-v2")
    rr, cc = np.meshgrid(np.arange(env.rows), np.arange(env.cols), indexing="ij")
    grid = env._is_storage(torch.as_tensor(rr), torch.as_tensor(cc)).numpy()
    np.testing.assert_array_equal(grid, jenv._storage_grid())
    np.testing.assert_array_equal(grid, env._storage_grid())
    assert grid.sum() == env.n_shelves


def test_request_resample_keeps_the_queue_and_draws_uniformly():
    """20,000 envs of rware-tiny-2ag (S = 48 shelves, queue 2) where both
    agents stand on the goal cells carrying a requested shelf each: one step
    retires both requests and draws two. The queue keeps its size; each
    draw is a shelf that was not requested when it was drawn (a retired one
    may come back); over the first draws every eligible shelf turns up
    with frequency within 5 sigma of uniform, and the total-variation
    distance is that of two uniform samples."""
    E = 20_000
    env = parse_rware_name("rware-tiny-2ag-v2")
    S, q = env.n_shelves, env.request_queue_size
    state, _ = env.reset_batch(torch.Generator().manual_seed(0), E)
    req = torch.zeros((S, E), dtype=torch.bool)
    req[[5, 17]] = True  # the same two requests everywhere
    goal_r, goal_c = env.rows - 1, env.cols // 2 - 1
    state.requested = req
    state.agent_r = torch.full((2, E), goal_r, dtype=torch.int32)
    state.agent_c = torch.tensor([[goal_c], [goal_c + 1]], dtype=torch.int32).expand(2, E).contiguous()
    state.carrying = torch.tensor([[5], [17]], dtype=torch.int32).expand(2, E).contiguous()
    state.shelf_carried[[5, 17]] = True
    state.shelf_r[[5, 17]] = goal_r
    state.shelf_c[5], state.shelf_c[17] = goal_c, goal_c + 1
    nxt, ts = env.step_batch(state, torch.full((E, 2), NOOP), torch.Generator().manual_seed(1))
    assert bool((ts.reward == 1).all())
    new = nxt.requested.numpy()
    assert np.all(new.sum(0) == q)
    # agent 0's draw: uniform over all 48 shelves (both were retired first);
    # agent 1's: over the 47 that agent 0's draw left
    drawn = [np.flatnonzero(new[:, e]) for e in range(E)]
    assert all(len(d) == 2 for d in drawn)
    counts = np.bincount(np.concatenate(drawn), minlength=S)
    p = 2 / S
    assert np.all(np.abs(counts / E - p) <= 5 * np.sqrt(p * (1 - p) / E)), counts
    flat = np.concatenate(drawn)
    uniform = np.random.default_rng(2).integers(0, S, size=flat.size)
    tv = 0.5 * np.abs(np.bincount(flat, minlength=S) / flat.size - np.bincount(uniform, minlength=S) / flat.size).sum()
    assert tv < 2.5 * np.sqrt(S / (np.pi * flat.size)) + 0.005


def _tv(a, b, bins):
    pa = np.bincount(a, minlength=bins) / len(a)
    pb = np.bincount(b, minlength=bins) / len(b)
    return 0.5 * np.abs(pa - pb).sum()


@pytest.mark.parametrize("name", ["rware-tiny-2ag-v2", "rware-small-4ag-hard-v2"])
def test_reset_spawn_marginals_match_jax(name):
    """Agent cells and directions and requested shelves over 16384 resets
    per package: total-variation distance under 2.5x that of two samples of
    one distribution; agents on distinct cells, shelves at home, nothing
    carried, the queue full; the reset's obs is the JAX build's."""
    E = 16384
    jenv, env = jax_parse_rware_name(name), parse_rware_name(name)
    jstate, _ = jax.jit(jenv.reset_batch, static_argnums=1)(jax.random.PRNGKey(7), E)
    state, ts = env.reset_batch(torch.Generator().manual_seed(7), E)
    got, ref = {k: getattr(state, k).numpy() for k in STATE_FIELDS}, _arrays(jstate)
    np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(jax.jit(jenv._make_obs_batch)(to_jax_state(got))))
    for k in ("carrying", "shelf_r", "shelf_c", "shelf_carried", "t"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert np.all(got["requested"].sum(0) == env.request_queue_size)
    cells = got["agent_r"] * env.cols + got["agent_c"]
    assert all(len(set(cells[:, e])) == env.num_agents for e in range(0, E, 97))
    jcells = ref["agent_r"] * env.cols + ref["agent_c"]
    checks = [(cells[i], jcells[i], env.rows * env.cols) for i in range(env.num_agents)]
    checks += [(got["agent_dir"][i], ref["agent_dir"][i], 4) for i in range(env.num_agents)]
    checks.append((np.nonzero(got["requested"])[0], np.nonzero(ref["requested"])[0], env.n_shelves))
    for a, b, bins in checks:
        n = min(len(a), len(b))
        assert _tv(a, b, bins) < 2.5 * np.sqrt(bins / (np.pi * n)) + 0.005


def test_parse_names_like_jax():
    for name in ("rware:rware-tiny-2ag-v2", "rware-small-4ag-easy-v2", "rware-medium-6ag-hard-v2", "rware-large-3ag-v2"):
        env, jenv = parse_rware_name(name), jax_parse_rware_name(name)
        for f in ("shelf_rows", "shelf_columns", "num_agents", "request_queue_size", "obs_dim"):
            assert getattr(env, f) == getattr(jenv, f), (name, f)
    with pytest.raises(ValueError, match="unknown rware size"):
        parse_rware_name("rware-huge-2ag-v2")


def test_random_policy_episodes_deliver_at_the_jax_rate():
    """Whole T=500 episodes of rware-tiny-2ag-v2 under a uniform random
    policy, 2048 a package: the reset's joint draw, the steps and the
    requests drawn after each delivery together give the JAX package's
    delivery rate (counts within 4 standard deviations of their Poisson
    difference). The learning gate's ia2c_rware runs start from this rate."""
    from codebase_tpu.envs.factory import make_env as jax_make_env
    from codebase_tpu_torch.envs.factory import make_env

    E, T = 2048, 500
    jenv, env = jax_make_env("rware-tiny-2ag-v2", time_limit=T), make_env("rware-tiny-2ag-v2", time_limit=T)
    key, k = jax.random.split(jax.random.PRNGKey(1))
    jstate, _ = jenv.reset_batch(k, E)
    jstep = jax.jit(jenv.step_batch)
    g = torch.Generator().manual_seed(1)
    state, _ = env.reset_batch(g, E)
    jax_total, total = 0.0, 0.0
    for _ in range(T):
        key, ka, ks = jax.random.split(key, 3)
        jstate, jts = jstep(jstate, jax.random.randint(ka, (E, jenv.n_agents), 0, jenv.n_actions), ks)
        jax_total += float(np.asarray(jts.reward).sum())
        state, ts = env.step_batch(state, torch.randint(0, env.n_actions, (E, env.n_agents), generator=g), g)
        total += float(ts.reward.sum())
    assert jax_total > 10 and total > 10  # deliveries happen under a random policy
    assert abs(total - jax_total) <= 4 * np.sqrt(total + jax_total), (total, jax_total)
