"""The port's standardisation ops and reward/observation wrappers against the
JAX package's, on the same numpy inputs: `RunningMeanStd` over several
batches, the persistent reward stream over a rollout with ragged `filled`,
the reward plans of the wrapper stacks `make_env` builds (with the same
warnings), and `ObserveID`/`CooperativeReward` stepped bit-exactly from a
state made on the JAX side."""

import warnings
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codebase_tpu.envs import wrappers as JW
from codebase_tpu.envs.factory import make_env as jax_make_env
from codebase_tpu.ops import reward_stream as jrs
from codebase_tpu.ops.running_stats import RunningMeanStd as JaxRunningMeanStd
from codebase_tpu_torch.envs import wrappers as W
from codebase_tpu_torch.envs.factory import make_env
from codebase_tpu_torch.envs.lbforaging import LBFBatchState
from codebase_tpu_torch.ops import reward_stream as rs
from codebase_tpu_torch.ops.running_stats import RunningMeanStd

torch.set_num_threads(2)
T, E, N = 5, 8, 3


def _close(got, ref, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", [(3,), (1,)])
def test_running_mean_std_matches_jax_over_several_batches(shape):
    rng = np.random.default_rng(0)
    jrms, rms = JaxRunningMeanStd.init(shape), RunningMeanStd.init(shape)
    assert rms.count.dtype == torch.float32 and float(rms.count) == np.float32(1e-4)
    # several batch sizes, one of a single row (variance 0)
    for rows in (40, 1, 7, 130):
        x = (rng.standard_normal((rows,) + shape) * 3 + 1.5).astype(np.float32)
        jrms, rms = jrms.update(jnp.asarray(x)), rms.update(torch.tensor(x))
        for f in ("mean", "var", "count"):
            _close(getattr(rms, f).numpy(), getattr(jrms, f))
    y = rng.standard_normal((6,) + shape).astype(np.float32)
    _close(rms.normalise(torch.tensor(y)).numpy(), jrms.normalise(jnp.asarray(y)))
    _close(rms.denormalise(torch.tensor(y)).numpy(), jrms.denormalise(jnp.asarray(y)))


def _ragged_rollout(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, size=E)
    filled = (np.arange(T)[:, None] < lengths[None]).astype(np.float32)  # (T, E)
    rewards = (rng.random((T, E, N)) * (rng.random((T, E, N)) < 0.5)).astype(np.float32)
    return rewards * filled[..., None], filled


def _stream_pair(seed):
    """A stream that has already seen a rollout, on both sides."""
    r, f = _ragged_rollout(seed)
    js, _ = jrs.standardise_rollout(jrs.RewardStream.init(E, N), jnp.asarray(r), jnp.asarray(f))
    ts, _ = rs.standardise_rollout(rs.RewardStream.init(E, N), torch.tensor(r), torch.tensor(f))
    return js, ts


def _assert_stream_equal(js, ts):
    for f in fields(rs.RewardStream):
        _close(getattr(ts, f.name).numpy(), getattr(js, f.name), atol=1e-7)


def test_stream_update_matches_jax():
    js, ts = _stream_pair(1)
    r = np.random.default_rng(2).random((E, N)).astype(np.float32)
    jnew, jout = jrs.stream_update(js, jnp.asarray(r))
    new, out = rs.stream_update(ts, torch.tensor(r))
    _assert_stream_equal(jnew, new)
    _close(out.numpy(), jout, atol=1e-7)
    # the first sample of a fresh stream passes through raw
    _, first = rs.stream_update(rs.RewardStream.init(E, N), torch.tensor(r))
    np.testing.assert_array_equal(first.numpy(), r)


def test_standardise_rollout_matches_jax_with_ragged_filled():
    js, ts = _stream_pair(3)
    r, f = _ragged_rollout(4)
    jnew, jout = jrs.standardise_rollout(js, jnp.asarray(r), jnp.asarray(f))
    new, out = rs.standardise_rollout(ts, torch.tensor(r), torch.tensor(f))
    _assert_stream_equal(jnew, new)
    _close(out.numpy(), jout, atol=1e-6)
    # only filled steps update a stream, and unfilled steps output 0
    np.testing.assert_array_equal(new.n.numpy() - ts.n.numpy(), f.sum(0))
    assert np.all(out.numpy()[f == 0] == 0)


STACKS = {
    "flag": dict(standardise_rewards=True),
    "flag_cooperative": dict(standardise_rewards=True, wrappers=["CooperativeReward"]),
    "named": dict(wrappers=["CooperativeReward", "StandardiseReward", "RecordEpisodeStatistics"]),
    "duplicate": dict(standardise_rewards=True, wrappers=["StandardiseReward", "ClearInfo"]),
    "normalize_reward": dict(wrappers=["NormalizeReward", "FlattenObservation"]),
    "none": dict(observe_id=True, wrappers=["CooperativeReward"]),
}


def _built(make, kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        env = make("lbforaging:Foraging-8x8-3p-2f-v3", 25, **kw)
    return env, [str(w.message) for w in caught]


@pytest.mark.parametrize("stack", list(STACKS))
def test_standardisation_plan_and_warnings_match_jax(stack):
    jenv, jwarn = _built(jax_make_env, STACKS[stack])
    env, warn = _built(make_env, STACKS[stack])
    assert warn == jwarn
    assert (env.obs_dim, env.n_agents, env.integer_valued_obs) == (
        jenv.obs_dim, jenv.n_agents, jenv.integer_valued_obs)
    jplan, plan = JW.standardisation_plan(jenv), W.standardisation_plan(env)
    if jplan is None:
        assert plan is None
        return
    assert (len(plan.below), len(plan.above)) == (len(jplan.below), len(jplan.above))
    # the plan applied to a rollout's raw rewards
    r, f = _ragged_rollout(5)
    js, ts = _stream_pair(6)
    jnew, jout = jrs.apply_plan(jplan, js, jnp.asarray(r), jnp.asarray(f))
    new, out = rs.apply_plan(plan, ts, torch.tensor(r), torch.tensor(f))
    _assert_stream_equal(jnew, new)
    _close(out.numpy(), jout, atol=1e-6)


def test_unknown_wrapper_raises_listing_the_supported_set():
    with pytest.raises(ValueError, match="Supported named wrappers") as err:
        make_env("lbforaging:Foraging-8x8-2p-3f-v3", 25, wrappers=["TransformReward"])
    assert str(sorted(W.NAMED_WRAPPERS)) in str(err.value)
    assert sorted(W.NAMED_WRAPPERS) == sorted(JW.NAMED_WRAPPERS)


def _to_torch_state(js):
    inner = LBFBatchState(**{f.name: torch.as_tensor(np.array(getattr(js.inner, f.name)))
                             for f in fields(LBFBatchState)})
    return W.TimeLimitState(inner=inner, t=torch.as_tensor(np.array(js.t)))


@pytest.mark.parametrize("name", ["lbforaging:Foraging-8x8-3p-2f-v3", "lbforaging:Foraging-5x5-2p-1f-v3"])
def test_observe_id_and_cooperative_reward_match_jax_exactly(name):
    """ObserveID prepends the one-hot id; CooperativeReward gives every agent
    the team sum and leaves `stat_reward` raw. Bit-exact against the JAX
    stack from the same state and actions."""
    kw = dict(observe_id=True, wrappers=["CooperativeReward"])
    jenv, env = jax_make_env(name, 10, **kw), make_env(name, 10, **kw)
    assert env.obs_dim == jenv.obs_dim == jenv.base_env.obs_dim + jenv.n_agents
    jstate, _ = jax.jit(jenv.reset_batch, static_argnums=1)(jax.random.PRNGKey(0), 64)
    state = _to_torch_state(jstate)
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(2)
    jax_step = jax.jit(jenv.step_batch)
    rewarded = 0
    for _ in range(12):
        a = rng.choice(6, size=(64, env.n_agents), p=[0.1, 0.12, 0.12, 0.12, 0.12, 0.42])
        jstate, jts = jax_step(jstate, jnp.asarray(a, jnp.int32), key)
        state, ts = env.step_batch(state, torch.as_tensor(a))
        for field in ("obs", "reward", "stat_reward", "terminated", "truncated", "action_mask"):
            np.testing.assert_array_equal(getattr(ts, field).numpy(), np.asarray(getattr(jts, field)),
                                          err_msg=field)
        rewarded += int((np.asarray(jts.stat_reward) > 0).sum())
    assert rewarded > 0, "no reward was given: the team sum went untested"
    assert torch.equal(ts.reward, ts.stat_reward.sum(-1, keepdim=True).expand_as(ts.reward))
