"""The port's rollout collector, replay buffer and epsilon schedule against
the JAX package's, on the same inputs.

The collector is driven by one numpy action table on both sides, and the
port env's `reset_batch` returns the JAX reset (converted), so every
`Rollout` field must match exactly. Replay inserts use synthetic rollouts
across a ring wrap-around, in both slot-reuse modes.
"""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codebase_tpu.envs.factory import make_env as jax_make_env
from codebase_tpu.envs.vector import Rollout as JaxRollout
from codebase_tpu.envs.vector import collect_episodes as jax_collect_episodes
from codebase_tpu.ops import replay as jreplay
from codebase_tpu.ops.schedules import epsilon_schedule as jax_epsilon_schedule
from codebase_tpu_torch.envs.api import TimeStep
from codebase_tpu_torch.envs.factory import make_env
from codebase_tpu_torch.envs.lbforaging import LBFBatchState
from codebase_tpu_torch.envs.vector import Rollout, collect_episodes
from codebase_tpu_torch.envs.wrappers import TimeLimit, TimeLimitState
from codebase_tpu_torch.ops import replay
from codebase_tpu_torch.ops.schedules import epsilon_schedule

torch.set_num_threads(2)
ROLLOUT_FIELDS = [f.name for f in fields(Rollout)]


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("proper", [False, True])
def test_collect_episodes_matches_jax(proper, monkeypatch):
    name, T, E = "lbforaging:Foraging-5x5-2p-1f-v3", 12, 32
    jenv = jax_make_env(name, time_limit=T)
    env = make_env(name, time_limit=T)
    rng = np.random.default_rng(0)
    table = rng.choice(6, size=(T, E, 2), p=[0.1, 0.12, 0.12, 0.12, 0.12, 0.42])

    key = jax.random.PRNGKey(3)
    k_reset, _ = jax.random.split(key)  # the reset key `collect_episodes` uses
    jstate, jts = jax.jit(jenv.reset_batch, static_argnums=1)(k_reset, E)
    state = TimeLimitState(
        inner=LBFBatchState(**{f.name: _t(getattr(jstate.inner, f.name)) for f in fields(LBFBatchState)}),
        t=_t(jstate.t),
    )
    ts = TimeStep(**{f.name: _t(getattr(jts, f.name)) for f in fields(TimeStep)})
    monkeypatch.setattr(TimeLimit, "reset_batch", lambda self, generator, n: (state, ts))

    jtable = jnp.asarray(table, jnp.int32)

    def jax_policy(carry, obs, mask, k):
        return carry + 1, jtable[carry]

    def policy(carry, obs, mask, generator):
        return carry + 1, torch.as_tensor(table[carry])

    jroll, jcarry = jax.jit(
        lambda k: jax_collect_episodes(jenv, jax_policy, jnp.int32(0), k, E, T, proper, early_exit=False)
    )(key)
    roll, carry = collect_episodes(env, policy, 0, torch.Generator(), E, T, proper)
    assert carry == int(jcarry) == T
    for f in ROLLOUT_FIELDS:
        np.testing.assert_array_equal(getattr(roll, f).numpy(), np.asarray(getattr(jroll, f)), err_msg=f)
    lengths = roll.episode_lengths.numpy()
    assert lengths.min() < T, "no episode ended early: the post-done masking went untested"
    np.testing.assert_array_equal(roll.episode_returns.numpy(), np.asarray(jroll.episode_returns))
    assert float(roll.env_steps) == float(jroll.env_steps)


def _synthetic_rollout(rng, T, E, N=2, D=5, A=6):
    """A rollout with episodes of random lengths and zeroed tails, integer
    obs (exact in bf16)."""
    lengths = rng.integers(1, T + 1, size=E)
    filled = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)  # (T, E)
    boundary = np.concatenate([np.ones((1, E), np.float32), filled], axis=0)
    obs = rng.integers(-1, 9, size=(T + 1, E, N, D)).astype(np.float32) * boundary[..., None, None]
    mask = np.where(boundary[..., None, None] > 0, rng.integers(0, 2, size=(T + 1, E, N, A)), 1).astype(np.float32)
    return dict(
        obs=obs,
        actions=(rng.integers(0, A, size=(T, E, N)) * filled[..., None]).astype(np.int32),
        rewards=(rng.standard_normal((T, E, N)) * filled[..., None]).astype(np.float32),
        stat_rewards=np.zeros((T, E, N), np.float32),
        dones=np.concatenate([np.zeros((1, E)), (np.arange(T)[:, None] == lengths[None] - 1)], 0).astype(np.float32),
        filled=filled,
        action_mask=mask,
    )


def _assert_buffers_equal(jbuf, buf):
    for f in ("obs", "actions", "rewards", "dones", "filled", "action_mask"):
        np.testing.assert_array_equal(
            getattr(buf, f).float().numpy(), np.asarray(getattr(jbuf, f), np.float32), err_msg=f
        )
    assert buf.pos == int(jbuf.pos)


@pytest.mark.parametrize("slot_reuse", ["reference", "clear"])
@pytest.mark.parametrize("size,dtype", [(6, "bfloat16"), (8, "float32")])
def test_replay_add_and_gather_match_jax(slot_reuse, size, dtype):
    """size 6 with E=4 exercises the JAX scatter insert, size 8 its
    contiguous-slice insert; three inserts wrap the ring."""
    T, E, N, D, A = 5, 4, 2, 5, 6
    rng = np.random.default_rng(1)
    jbuf = jreplay.replay_init(size, T, N, D, A, with_mask=True, obs_dtype=jnp.dtype(dtype))
    buf = replay.replay_init(size, T, N, D, A, with_mask=True, obs_dtype=getattr(torch, dtype))
    jadd = jax.jit(jreplay.replay_add, static_argnums=2)
    for _ in range(3):
        r = _synthetic_rollout(rng, T, E, N, D, A)
        jbuf = jadd(jbuf, JaxRollout(**{k: jnp.asarray(v) for k, v in r.items()}), slot_reuse)
        buf = replay.replay_add(buf, Rollout(**{k: torch.as_tensor(v).clone() for k, v in r.items()}), slot_reuse)
        _assert_buffers_equal(jbuf, buf)

    # the gather of replay_sample_many on the indices the JAX side draws
    B, n = 3, 2
    k = jax.random.PRNGKey(4)
    idx = jax.random.randint(k, (n * B,), 0, jbuf.num_stored)
    jb = jreplay.replay_sample_many(jbuf, k, B, n)
    b = replay.gather_batches(buf, _t(idx).long(), B, n)
    for f in jb:
        np.testing.assert_array_equal(b[f].float().numpy(), np.asarray(jb[f], np.float32), err_msg=f)
    for u in range(n):
        jref = jreplay.batch_to_reference_layout({f: v[u] for f, v in jb.items()})
        ref = replay.batch_to_reference_layout({f: v[u] for f, v in b.items()})
        for f in jref:
            assert ref[f].shape == jref[f].shape, f
            np.testing.assert_array_equal(ref[f].float().numpy(), np.asarray(jref[f], np.float32), err_msg=f)
        assert ref["obss"].dtype == torch.float32

    drawn = replay.replay_sample_many(buf, torch.Generator().manual_seed(0), B, n)
    assert drawn["obss"].shape == (n, B, T + 1, N, D)


@pytest.mark.parametrize("style", ["linear", "exponential"])
def test_epsilon_schedule_matches_jax(style):
    args = (style, 0.5, 1.0, 0.05, 6.5, 100_000)
    jsched, sched = jax_epsilon_schedule(*args), epsilon_schedule(*args)
    for step in [0, 1, 999, 25_000, 49_999, 50_000, 77_777, 100_000]:
        np.testing.assert_allclose(sched(step), float(jsched(step)), rtol=1e-6, err_msg=str(step))
