"""The port's Gymnasium views (`codebase_tpu_torch/envs/gym_compat.py`) on
the CPU: the contract `tests/test_gym_compat.py` pins for the JAX package
(tuple observations, per-agent reward lists, masks in `info`, truncation,
pre-1.0 same-step autoreset with `final_info` and `final_observation`,
episode statistics), the ImportError without gymnasium, and the batched
view's steps against `JaxVectorEnv`'s from a common state (exactly equal:
the LBF dynamics draw nothing while no episode ends)."""

import numpy as np
import pytest
import torch

gym = pytest.importorskip("gymnasium")

import jax.numpy as jnp  # noqa: E402

from codebase_tpu.envs import wrappers as JW  # noqa: E402
from codebase_tpu.envs.factory import make_base_env as jax_make_base_env  # noqa: E402
from codebase_tpu.envs.gym_compat import JaxVectorEnv  # noqa: E402
from codebase_tpu_torch.envs import gym_compat  # noqa: E402
from codebase_tpu_torch.envs import wrappers as W  # noqa: E402
from codebase_tpu_torch.envs.factory import make_base_env  # noqa: E402
from codebase_tpu_torch.envs.gym_compat import GymnasiumEnv, SyncVectorEnv, TorchVectorEnv  # noqa: E402
from codebase_tpu_torch.envs.lbforaging import LBFBatchState  # noqa: E402
from codebase_tpu_torch.envs.wrappers import TimeLimitState  # noqa: E402

torch.set_num_threads(2)
LBF = "lbforaging:Foraging-8x8-2p-3f-v3"
T = 25
CPU = "cpu"


def _lbf(limit=T):
    return W.TimeLimit(make_base_env(LBF), limit=limit)


def test_single_env_reset_and_step_contract():
    env = GymnasiumEnv(_lbf(), seed=0, device=CPU)
    obs, info = env.reset()
    assert isinstance(obs, tuple) and len(obs) == 2
    for o, space in zip(obs, env.observation_space):
        assert o.shape == space.shape and o.dtype == np.float32
    assert env.unwrapped.n_agents == 2 and "action_mask" not in info  # LBF does not mask
    env.reset(seed=1)
    for t in range(1, T + 1):
        obs, rewards, terminated, truncated, info = env.step([0, 0])
        assert isinstance(rewards, list) and len(rewards) == 2
        assert isinstance(terminated, bool) and isinstance(truncated, bool)
        if t < T:
            assert not truncated
    assert truncated and not terminated  # noops never end LBF: the 25th step truncates
    with pytest.raises(ValueError, match="expected 2 actions"):
        env.step([0, 0, 0])


def test_single_env_seed_determinism_and_masks():
    a, b = GymnasiumEnv(_lbf(), seed=3, device=CPU), GymnasiumEnv(_lbf(), seed=3, device=CPU)
    for x, y in zip(a.reset(seed=3)[0], b.reset(seed=3)[0]):
        np.testing.assert_array_equal(x, y)
    for _ in range(5):
        sa, sb = a.step([1, 2]), b.step([1, 2])
        for x, y in zip(sa[0], sb[0]):
            np.testing.assert_array_equal(x, y)
        assert sa[1] == sb[1]
    spec = W.TimeLimit(make_base_env("smaclite:3m-v0"), limit=30)
    env = GymnasiumEnv(spec, seed=0, device=CPU)
    _, info = env.reset()
    mask = info["action_mask"]
    assert mask.shape == (env.n_agents, spec.n_actions) and mask.min() >= 0.0 and mask.max() == 1.0


def test_vector_env_episode_stats_and_autoreset():
    envs = TorchVectorEnv(_lbf(limit=5), num_envs=3, seed=0, device=CPU)
    obs, _ = envs.reset()
    assert len(obs) == 2 and obs[0].shape == (3, envs.single_observation_space[0].shape[0])
    assert envs.observation_space[0].shape[0] == 3
    acc = np.zeros((3, 2), np.float32)
    agent_major = [[1] * 3, [2] * 3]
    for t in range(1, 6):
        obs, rewards, terminated, truncated, info = envs.step(agent_major)
        assert rewards.shape == (3, 2)
        done = np.logical_or(terminated, truncated)
        acc += rewards
        if t < 5:
            assert not done.any()
    assert done.all() and "final_info" in info and "final_observation" in info
    for j in range(3):
        fi = info["final_info"][j]
        np.testing.assert_allclose(fi["episode_returns"], acc[j], rtol=1e-6)
        assert fi["episode_length"] == 5 and "agent0/episode_returns" in fi
        assert isinstance(info["final_observation"][j], tuple)
    # the returned obs is a fresh episode's; the next step continues from it
    _, _, term2, trunc2, _ = envs.step(agent_major)
    assert not np.logical_or(term2, trunc2).any()
    assert int(envs._state.t.max()) == 1
    with pytest.raises(ValueError, match="bad vector action shape"):
        envs.step([[1, 2]])


def test_vector_env_masks_and_cuda_default():
    envs = TorchVectorEnv(W.TimeLimit(make_base_env("smaclite:3m-v0"), limit=30), num_envs=2, device=CPU)
    _, info = envs.reset(seed=1)
    assert info["action_mask"].shape == (2, 3, envs._env.n_actions)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            TorchVectorEnv(_lbf(), num_envs=2)  # the batched view runs on the card by default
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            GymnasiumEnv(_lbf())  # and so does the single-env view


def test_sync_vector_env_final_info_and_autoreset():
    def thunk(seed):
        def make():
            env = GymnasiumEnv(_lbf(limit=4), seed=seed, device=CPU)
            env.reset(seed=seed)
            return env

        return make

    envs = SyncVectorEnv([thunk(i) for i in range(2)])
    obs, _ = envs.reset()
    assert obs[0].shape == (2, envs.single_observation_space[0].shape[0])
    for _ in range(4):
        obs, rewards, terminated, truncated, info = envs.step([[0, 0], [0, 0]])
    assert truncated.all() and all(fi is not None for fi in info["final_info"])
    envs.step([[0, 0], [0, 0]])  # the autoreset envs step on


def test_each_view_raises_import_error_without_gymnasium(monkeypatch):
    monkeypatch.setattr(gym_compat, "_gym", None)
    for make in (lambda: GymnasiumEnv(_lbf(), device=CPU), lambda: TorchVectorEnv(_lbf(), 2, device=CPU),
                 lambda: SyncVectorEnv([])):
        with pytest.raises(ImportError, match="gymnasium is required"):
            make()


def test_vector_env_steps_equal_jax_vector_env_from_a_common_state():
    """JaxVectorEnv's state (per-env, env axis first) carried into the
    port's batched view (env axis last); the same numpy actions, with no
    LOAD so that no episode ends and no reset draws, give exactly the same
    observations, rewards, flags and states."""
    B, steps = 8, 6
    jenvs = JaxVectorEnv(JW.TimeLimit(jax_make_base_env(LBF), limit=T), num_envs=B, seed=0)
    jobs, _ = jenvs.reset()
    envs = TorchVectorEnv(_lbf(), num_envs=B, seed=0, device=CPU)
    envs.reset()
    js = jenvs._state
    pos = np.asarray(js.inner.agent_pos)
    fpos = np.asarray(js.inner.food_pos)
    last = lambda x: torch.as_tensor(np.ascontiguousarray(np.moveaxis(np.array(x), 0, -1)))  # noqa: E731
    envs._state = TimeLimitState(
        inner=LBFBatchState(
            agent_r=last(pos[..., 0]), agent_c=last(pos[..., 1]), agent_level=last(js.inner.agent_level),
            food_r=last(fpos[..., 0]), food_c=last(fpos[..., 1]), food_level=last(js.inner.food_level),
            food_active=last(js.inner.food_active), food_spawned=last(js.inner.food_spawned),
            t=last(js.inner.t),
        ),
        t=last(js.t),
    )
    rng = np.random.default_rng(0)
    for _ in range(steps):
        acts = rng.integers(0, 5, size=(2, B))  # agent-major, no LOAD (action 5)
        jout, out = jenvs.step(jnp.asarray(acts).tolist()), envs.step(acts)
        for a, b in zip(out[0], jout[0]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(out[1:4], jout[1:4]):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert "final_info" not in out[4] and "final_info" not in jout[4]
    np.testing.assert_array_equal(envs._state.inner.agent_r.numpy(), np.asarray(jenvs._state.inner.agent_pos)[..., 0].T)
    np.testing.assert_array_equal(envs._state.t.numpy(), np.asarray(jenvs._state.t))
