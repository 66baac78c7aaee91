"""The port's batched SMAClite against the JAX package's.

`step_batch`, the observations and the action masks must match exactly on
states made by the JAX `reset_batch` (and on planted states: ties, healers,
invalid actions) and on numpy-drawn actions; the dynamics ignore the key.
Spawning draws different random numbers on each side, so the reset is held
to the JAX package by its marginal distributions. Last, QMIX and MAPPO
train through the mask path on the CPU with finite losses.
"""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codebase_tpu.envs.smaclite import CombatBatchState as JaxCombatBatchState
from codebase_tpu.envs.smaclite import SmacLiteCombat as JaxSmacLiteCombat
from codebase_tpu.envs.smaclite import parse_smaclite_name as jax_parse_smaclite_name
from codebase_tpu_torch.algos import ac, dqn
from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.envs.factory import make_env
from codebase_tpu_torch.envs.smaclite import (
    STOP,
    UNIT_STATS,
    CombatBatchState,
    SmacLiteCombat,
    parse_smaclite_name,
)

torch.set_num_threads(2)
CPU = torch.device("cpu")
STATE_FIELDS = [f.name for f in fields(CombatBatchState)]


def to_torch_state(js) -> CombatBatchState:
    return CombatBatchState(**{k: torch.as_tensor(np.array(getattr(js, k))) for k in STATE_FIELDS})


def to_jax_state(arrays) -> JaxCombatBatchState:
    return JaxCombatBatchState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def assert_state_equal(js, ts, msg=""):
    for k in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), err_msg=f"{msg} {k}")


def assert_timestep_equal(jts, ts, msg=""):
    for k in ("obs", "reward", "stat_reward", "terminated", "truncated", "action_mask"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(jts, k)), err_msg=f"{msg} {k}")


def draw_actions(rng, mask, p_valid=0.85):
    """Valid actions drawn uniformly from each agent's mask, with a share
    1 - p_valid of uniform draws over every action (most of them invalid)."""
    E, N, A = mask.shape
    u = rng.random((E, N, A)) * mask
    valid = u.argmax(-1)
    anything = rng.integers(0, A, size=(E, N))
    return np.where(rng.random((E, N)) < p_valid, valid, anything)


@pytest.mark.parametrize("name", ["smaclite:3m-v0", "smaclite:2s3z-v0", "smaclite:MMM2-v0"])
def test_step_obs_and_mask_match_jax_exactly(name):
    """40 steps of 64 envs; 15% of the actions drawn over every action, so
    invalid ones (which become STOP) are taken too. The `current_mask`
    shortcut gives the same step as recomputing the mask."""
    E, steps = 64, 40
    jenv, env = jax_parse_smaclite_name(name), parse_smaclite_name(name)
    for prop in ("n_agents", "n_actions", "obs_dim", "type_bits", "max_reward"):
        assert getattr(env, prop) == getattr(jenv, prop), prop
    jstate, jts = jax.jit(jenv.reset_batch, static_argnums=1)(jax.random.PRNGKey(0), E)
    state = to_torch_state(jstate)
    obs, mask = env._outputs_batch(state)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jts.obs))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jts.action_mask))
    rng = np.random.default_rng(1)
    jax_step = jax.jit(jenv.step_batch)
    tmask, rewarded, dead = mask, 0, 0
    for t in range(steps):
        a = draw_actions(rng, np.asarray(jts.action_mask))
        prev = state
        jstate, jts = jax_step(jstate, jnp.asarray(a, jnp.int32), jax.random.PRNGKey(t), jts.action_mask)
        state, ts = env.step_batch(state, torch.as_tensor(a), None, tmask)
        assert_state_equal(jstate, state, f"step {t}")
        assert_timestep_equal(jts, ts, f"step {t}")
        if t % 10 == 0:  # the shortcut changes nothing
            again, ts2 = env.step_batch(prev, torch.as_tensor(a))
            assert_state_equal(jstate, again, f"step {t} without current_mask")
            assert_timestep_equal(jts, ts2, f"step {t} without current_mask")
        tmask = ts.action_mask
        rewarded += int((ts.reward > 0).sum())
        dead += int((state.ally_hp <= 0).sum())
    assert rewarded > 0 and dead > 0, "no damage dealt or taken: the combat rules went untested"


def _planted(env, ally, enemy, ally_hp=None, enemy_hp=None, ally_cd=None, enemy_cd=None):
    """A one-env batch state from per-unit (row, col) lists."""
    N, M = len(ally), len(enemy)
    col = lambda v, dt: np.asarray(v, dt)[:, None]  # noqa: E731
    return dict(
        ally_r=col([p[0] for p in ally], np.int32), ally_c=col([p[1] for p in ally], np.int32),
        ally_hp=col(ally_hp if ally_hp is not None else env._stats(env.a_types, 0), np.float32),
        ally_cd=col(ally_cd if ally_cd is not None else [0] * N, np.int32),
        enemy_r=col([p[0] for p in enemy], np.int32), enemy_c=col([p[1] for p in enemy], np.int32),
        enemy_hp=col(enemy_hp if enemy_hp is not None else env._stats(env.e_types, 0), np.float32),
        enemy_cd=col(enemy_cd if enemy_cd is not None else [0] * M, np.int32),
        t=np.zeros((1,), np.int32),
    )


def _cat(states):
    return {k: np.concatenate([s[k] for s in states], axis=-1) for k in STATE_FIELDS}


PLANTED = dict(n_allies=3, n_enemies=3, ally_types=("medivac", "marine", "marine"),
               enemy_types=("marine", "medivac", "marine"), rows=8, cols=8)


def test_planted_ties_heals_kills_and_invalid_actions_match_jax():
    """Envs built to hit the rules' corners, one per column:
    0. two living allies at the same distance from an enemy in range: it
       shoots the first (argmin's first index); an enemy out of range with
       the same tie, and the enemy medivac, advance on the first; a dead
       ally is never the nearest;
    1. two damaged enemy teammates with the same deficit in a medivac's
       range: it heals the first (argmax's first index);
    2. two allies shoot a 6-hp enemy next to its ready medivac: no overkill
       credit, the kill bonus once, and it stays dead (the heal targets
       post-damage hp);
    3. the ally medivac heals a damaged marine, capped at max hp; a dead
       ally's heal slot is masked;
    4. NOOP while alive and an index past the action space become STOP; an
       attack on cooldown does not fire;
    5. every enemy dead: damage, two kill bonuses and the win bonus, and
       the episode ends;
    6. moves off the map become STOP."""
    jenv, env = JaxSmacLiteCombat(**PLANTED), SmacLiteCombat(**PLANTED)
    hp, ehp = env._stats(env.a_types, 0), env._stats(env.e_types, 0)
    states = [
        _planted(env, [(7, 7), (0, 2), (0, 4)], [(1, 3), (7, 0), (5, 3)], ally_hp=[0.0, hp[1], hp[2]]),
        _planted(env, [(7, 0), (7, 1), (7, 2)], [(0, 4), (0, 5), (0, 6)], enemy_hp=[20.0, ehp[1], 20.0]),
        _planted(env, [(0, 0), (0, 1), (1, 1)], [(0, 3), (0, 4), (7, 7)], enemy_hp=[6.0, ehp[1], 45.0]),
        _planted(env, [(7, 1), (7, 2), (6, 1)], [(0, 7), (0, 6), (1, 7)], ally_hp=[hp[0], 40.0, 0.0]),
        _planted(env, [(0, 0), (3, 3), (7, 7)], [(0, 7), (3, 7), (7, 3)], ally_cd=[0, 1, 0]),
        _planted(env, [(2, 2), (2, 3), (2, 4)], [(2, 5), (0, 0), (2, 6)], enemy_hp=[6.0, 0.0, 6.0]),
        _planted(env, [(0, 0), (0, 7), (7, 0)], [(4, 4), (4, 5), (4, 6)]),
    ]
    actions = np.array([
        [STOP, STOP, STOP],
        [STOP, STOP, STOP],
        [STOP, 6, 6],
        [7, STOP, STOP],
        [0, 8, 15],
        [STOP, 6, 8],
        [2, 5, 15],
    ])
    arrays = _cat(states)
    jstate, state = to_jax_state(arrays), CombatBatchState(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    jmask = np.asarray(jenv._avail_actions_batch(jstate))
    np.testing.assert_array_equal(env._outputs_batch(state)[1].numpy(), jmask)
    assert jmask[3, 0, 7] == 1 and jmask[3, 0, 8] == 0 and jmask[4, 0, 0] == 0 and jmask[4, 1, 8] == 1
    jnext, jts = jax.jit(jenv.step_batch)(jstate, jnp.asarray(actions, jnp.int32), jax.random.PRNGKey(0))
    nxt, ts = env.step_batch(state, torch.as_tensor(actions))
    assert_state_equal(jnext, nxt)
    assert_timestep_equal(jts, ts)
    a_hp, e_hp = nxt.ally_hp.numpy(), nxt.enemy_hp.numpy()
    marine = UNIT_STATS["marine"][1]
    assert (a_hp[1, 0], a_hp[2, 0]) == (hp[1] - marine, hp[2])  # env 0: the first ally shot
    assert (nxt.enemy_r[2, 0], nxt.enemy_c[2, 0]) == (4, 2) and (nxt.enemy_r[1, 0], nxt.enemy_c[1, 0]) == (6, 1)
    assert (e_hp[0, 1], e_hp[2, 1]) == (20.0 + UNIT_STATS["medivac"][1], 20.0)  # env 1: the first teammate
    assert e_hp[0, 2] == 0.0  # env 2: killed, not resurrected
    np.testing.assert_allclose(float(ts.reward[2, 0]), (6.0 + env.kill_bonus) / env.max_reward, rtol=1e-6)
    assert (a_hp[1, 3], a_hp[2, 3]) == (45.0, 0.0)  # env 3: capped heal; the dead stay dead
    assert np.all(nxt.ally_cd.numpy()[:, 4] == 0)  # env 4: nobody fired
    np.testing.assert_allclose(float(ts.reward[5, 0]), (12.0 + 2 * env.kill_bonus + env.win_bonus) / env.max_reward,
                               rtol=1e-6)
    np.testing.assert_array_equal(ts.terminated.numpy(), [False] * 5 + [True, False])
    for e in (4, 6):  # nobody moved
        np.testing.assert_array_equal(nxt.ally_r.numpy()[:, e], arrays["ally_r"][:, e])
        np.testing.assert_array_equal(nxt.ally_c.numpy()[:, e], arrays["ally_c"][:, e])


def _tv(a, b, bins):
    pa = np.bincount(a, minlength=bins) / len(a)
    pb = np.bincount(b, minlength=bins) / len(b)
    return 0.5 * np.abs(pa - pb).sum()


@pytest.mark.parametrize("name", ["smaclite:3m-v0", "smaclite:2s3z-v0"])
def test_reset_spawn_marginals_match_jax(name):
    """Each unit's spawn row and column over 16384 resets per package:
    total-variation distance under 2.5x the distance expected between two
    samples of one distribution. hp, cooldowns and the step count are the
    JAX package's exactly, and the reset's obs and mask are the JAX build's
    on the port's state."""
    E = 16384
    jenv, env = jax_parse_smaclite_name(name), parse_smaclite_name(name)
    jstate, _ = jax.jit(jenv.reset_batch, static_argnums=1)(jax.random.PRNGKey(7), E)
    state, ts = env.reset_batch(torch.Generator().manual_seed(7), E)
    jts_obs, jts_mask = jax.jit(jenv._outputs_batch)(to_jax_state({k: getattr(state, k).numpy() for k in STATE_FIELDS}))
    np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(jts_obs))
    np.testing.assert_array_equal(ts.action_mask.numpy(), np.asarray(jts_mask))
    for k in ("ally_hp", "ally_cd", "enemy_hp", "enemy_cd", "t"):
        np.testing.assert_array_equal(getattr(state, k).numpy(), np.asarray(getattr(jstate, k)), err_msg=k)
    for k in ("ally_r", "ally_c", "enemy_r", "enemy_c"):
        got, ref = getattr(state, k).numpy(), np.asarray(getattr(jstate, k))
        for unit in range(got.shape[0]):
            bins = env.rows
            assert _tv(got[unit], ref[unit], bins) < 2.5 * np.sqrt(bins / (np.pi * E)) + 0.005, (k, unit)
    assert state.ally_c.max() < env.cols // 4 and state.enemy_c.min() >= 3 * env.cols // 4


def test_parse_names_like_jax():
    for name in ("smaclite:3m-v0", "smaclite:5m_vs_6m-v0", "2s3z", "3s5z", "smaclite:3s5z_vs_3s6z-v0", "MMM", "MMM2",
                 "smaclite:2m-v0"):
        env, jenv = parse_smaclite_name(name), jax_parse_smaclite_name(name)
        assert (env.a_types, env.e_types) == (jenv.a_types, jenv.e_types), name
        for prop in ("n_agents", "n_actions", "obs_dim", "type_bits", "max_reward"):
            assert getattr(env, prop) == getattr(jenv, prop), (name, prop)
    with pytest.raises(ValueError, match="unknown unit letter"):
        parse_smaclite_name("3q")
    assert make_env("smaclite:3m-v0", time_limit=60).has_action_mask


# ---------------------------------------------------------------- training


def _cfg(argv, E):
    cfg = load_config(argv)
    cfg.algorithm.parallel_envs = E
    return cfg


def test_qmix_trains_with_masks_on_smaclite():
    """QMIX on smaclite:2m: rollouts, f32 replay with masks, updates through
    the masked double-Q target; finite losses, and the policy's actions
    never leave the mask (they would turn into STOP in the env)."""
    cfg = _cfg(["+algorithm=qmix", "algorithm.training_start=0", "algorithm.buffer_size=64", "algorithm.batch_size=8",
                "algorithm.updates_per_collect=2"], E=4)
    env = make_env("smaclite:2m-v0", time_limit=30, wrappers=["CooperativeReward"])
    init_state, train_iteration, _ = dqn.build_train_functions(env, env, cfg.algorithm, 30, CPU)
    state = init_state(0)
    assert state.model.use_action_masks and state.buffer.obs.dtype == torch.float32
    losses = [float(train_iteration(state)["loss"]) for _ in range(3)]
    # the first iteration fills 4 of the 8 episodes a batch needs
    assert state.updates == 4 and np.isnan(losses[0]) and all(np.isfinite(losses[1:]))
    buf = state.buffer
    valid = buf.action_mask[:, :-1].gather(-1, buf.actions.unsqueeze(-1)).squeeze(-1)  # (S, T, N)
    filled = buf.filled[: buf.num_stored] > 0
    assert bool((valid[: buf.num_stored][filled] > 0).all())


def test_mappo_trains_with_masks_on_smaclite():
    """MAPPO on smaclite:2m through the masked sampling policy and the masked
    log-probs; finite losses and entropy."""
    cfg = _cfg(["+algorithm=mappo"], E=4)
    env = make_env("smaclite:2m-v0", time_limit=30)
    init_state, train_iteration, _, _ = ac.build_train_functions(env, env, cfg.algorithm, 30, CPU)
    state = init_state(0)
    assert state.model.use_action_masks
    for _ in range(2):
        out = train_iteration(state)
        assert all(np.isfinite(float(out[k])) for k in ac.METRICS)
    assert state.updates == 2
