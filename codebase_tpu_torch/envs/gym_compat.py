"""Gymnasium views of the port's batched environments.

The counterpart of the JAX package's `envs/gym_compat.py`: the port's env
specs (`envs/api.py`) behind the reference's multi-agent Gymnasium contract
(observations and rewards are one entry per agent), so that an external
Gym-based stack can drive them.

- `GymnasiumEnv`: one env instance, numpy in, numpy out. Tuple observation
  and action spaces, a per-agent reward list, `info["action_mask"]` when
  the env masks, and `unwrapped.n_agents`. It steps on `device` (default
  `cuda`, as the JAX view runs on the default device) and copies each
  step's results to the host.
- `TorchVectorEnv` (the JAX package's `JaxVectorEnv`): all sub-envs step
  in one batched call on `device` (default `cuda`), with the same-step
  autoreset in the same call (a fresh batch of resets, selected where an
  episode ended) and the reference's episode statistics kept on the host.
- `SyncVectorEnv`: a synchronous vector env over single-env thunks.

Both vector envs keep the pre-1.0 Gymnasium autoreset semantics the
reference was written against: a sub-env that ends is reset in the same
`step`, the reset observation is returned, and the terminal info and
observation appear under `info["final_info"]` and
`info["final_observation"]`.

`gymnasium` is optional: without it each class raises ImportError.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

try:  # gymnasium is optional for the core framework
    import gymnasium as _gym
    from gymnasium import spaces as _spaces

    _GymEnvBase = _gym.Env
except ImportError:  # pragma: no cover - exercised only without gymnasium
    _gym = None
    _spaces = None
    _GymEnvBase = object


def _require_gymnasium(what: str) -> None:
    if _gym is None:
        raise ImportError(f"gymnasium is required for {what}")


def _box_tuple(dims, lead=()):
    return _spaces.Tuple([_spaces.Box(-np.inf, np.inf, shape=tuple(lead) + (d,), dtype=np.float32) for d in dims])


def select_envs(done: torch.Tensor, new, old):
    """The batched env state `new` where `done` (E,) is True, else `old`.
    Every env state of the port keeps its env axis last ((E,), (N, E),
    (S, E) leaves, in nested dataclasses), so `done` broadcasts against
    each leaf."""
    if isinstance(old, torch.Tensor):
        if old.shape[-1:] != done.shape:
            raise ValueError(f"an env state leaf of shape {tuple(old.shape)} does not end in the env axis {tuple(done.shape)}")
        return torch.where(done, new, old)
    if dataclasses.is_dataclass(old):
        return dataclasses.replace(old, **{f.name: select_envs(done, getattr(new, f.name), getattr(old, f.name))
                                           for f in dataclasses.fields(old)})
    return old


def _check_device(device, what: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} on cuda was requested but no CUDA GPU is visible; pass device='cpu'")
    return device


class GymnasiumEnv(_GymEnvBase):
    """One instance of an env spec behind the Gymnasium API. `env` is any
    `codebase_tpu_torch.envs.api.Environment`, wrappers included (wrap in
    `envs.wrappers.TimeLimit` for truncation, where the reference applies
    `gym.wrappers.TimeLimit`). The env state lives on `device`."""

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, env, seed: Optional[int] = None, render_mode=None, device="cuda"):
        _require_gymnasium("GymnasiumEnv")
        self._env = env
        self.device = _check_device(device, "GymnasiumEnv")
        self.n_agents = env.n_agents
        self._obs_dims = tuple(env.obs_dims)
        self.observation_space = _box_tuple(self._obs_dims)
        self.action_space = _spaces.Tuple([_spaces.Discrete(a) for a in env.action_dims])
        self.render_mode = render_mode
        self._generator = torch.Generator(device=self.device).manual_seed(0 if seed is None else int(seed))
        self._state = None

    def _obs_tuple(self, obs):
        return tuple(obs[i, : self._obs_dims[i]] for i in range(self.n_agents))

    def _info(self, ts):
        if not self._env.has_action_mask:
            return {}
        return {"action_mask": ts.action_mask[0].cpu().numpy().astype(np.float32)}

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._generator.manual_seed(int(seed))
        self._state, ts = self._env.reset_batch(self._generator, 1)
        return self._obs_tuple(ts.obs[0].cpu().numpy().astype(np.float32)), self._info(ts)

    def step(self, actions):
        acts = np.asarray([int(a) for a in actions], dtype=np.int64)  # list, tuple, numpy or torch scalars
        if acts.shape != (self.n_agents,):
            raise ValueError(f"expected {self.n_agents} actions, got shape {acts.shape}")
        self._state, ts = self._env.step_batch(self._state, torch.as_tensor(acts[None], device=self.device),
                                               self._generator)
        obs = ts.obs[0].cpu().numpy().astype(np.float32)
        rewards = [float(r) for r in ts.reward[0].cpu().numpy()]
        return self._obs_tuple(obs), rewards, bool(ts.terminated[0]), bool(ts.truncated[0]), self._info(ts)

    def render(self):
        return self._env.render_frame(self._state)

    def close(self):
        pass

    @property
    def unwrapped(self):
        return self


def _object_array(items) -> np.ndarray:
    # fill a pre-allocated object array: np.array(list_of_tuples) would
    # broadcast the tuples into a 2-D array
    out = np.empty(len(items), dtype=object)
    for j, item in enumerate(items):
        out[j] = item
    return out


class TorchVectorEnv:
    """Vector env that steps all sub-envs in one batched call on `device`
    (default `cuda`), the same-step autoreset included, with the external
    surface and gym<1.0 semantics of `SyncVectorEnv`. Episode statistics
    are kept on the host with the reference's `RecordEpisodeStatistics`
    semantics: `final_info[j]` carries `episode_returns` (per agent,
    float32), `agent{i}/episode_returns`, `episode_length` and
    `episode_time`.

    `env` is an env spec; wrap it in `envs.wrappers.TimeLimit` for
    truncation, as the reference wraps each sub-env."""

    def __init__(self, env, num_envs: int, seed: Optional[int] = None, device="cuda"):
        _require_gymnasium("TorchVectorEnv")
        self._env = env
        self.num_envs = int(num_envs)
        self.n_agents = env.n_agents
        self.device = _check_device(device, "TorchVectorEnv")
        self._obs_dims = tuple(env.obs_dims)
        self.single_observation_space = _box_tuple(self._obs_dims)
        self.single_action_space = _spaces.Tuple([_spaces.Discrete(a) for a in env.action_dims])
        self.observation_space = _box_tuple(self._obs_dims, (self.num_envs,))
        self.action_space = _spaces.Tuple([_spaces.MultiDiscrete([a] * self.num_envs) for a in env.action_dims])
        self._generator = torch.Generator(device=self.device).manual_seed(0 if seed is None else int(seed))
        self._state = None
        B = self.num_envs
        self._ep_ret = np.zeros((B, self.n_agents), np.float32)
        self._ep_len = np.zeros((B,), np.int64)
        self._ep_t0 = np.zeros((B,), np.float64)

    def _obs_tuple(self, obs):
        return tuple(obs[:, i, : self._obs_dims[i]] for i in range(self.n_agents))

    def _mask_info(self, mask):
        return {"action_mask": mask.cpu().numpy().astype(np.float32)} if self._env.has_action_mask else {}

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._generator.manual_seed(int(seed))
        self._state, ts = self._env.reset_batch(self._generator, self.num_envs)
        self._ep_ret[:] = 0.0
        self._ep_len[:] = 0
        self._ep_t0[:] = time.perf_counter()
        return self._obs_tuple(ts.obs.cpu().numpy().astype(np.float32)), self._mask_info(ts.action_mask)

    def step(self, actions):
        acts = np.asarray(actions, dtype=np.int64)
        if acts.shape == (self.n_agents, self.num_envs):
            acts = acts.T  # agent-major, as the reference's AC loop sends them
        if acts.shape != (self.num_envs, self.n_agents):
            raise ValueError(f"bad vector action shape {acts.shape}")
        state, ts = self._env.step_batch(self._state, torch.as_tensor(acts, device=self.device), self._generator)
        done = ts.done
        # same-step autoreset: a fresh batch of resets, taken where an
        # episode ended
        reset_state, reset_ts = self._env.reset_batch(self._generator, self.num_envs)
        self._state = select_envs(done, reset_state, state)
        obs = torch.where(done[:, None, None], reset_ts.obs, ts.obs).cpu().numpy().astype(np.float32)
        mask = torch.where(done[:, None, None], reset_ts.action_mask, ts.action_mask)
        reward = ts.reward.cpu().numpy().astype(np.float32)
        terminated, truncated = ts.terminated.cpu().numpy(), ts.truncated.cpu().numpy()
        self._ep_ret += reward
        self._ep_len += 1
        done = np.logical_or(terminated, truncated)
        info = self._mask_info(mask)
        if done.any():
            final_info = [None] * self.num_envs
            final_observation = [None] * self.num_envs
            now = time.perf_counter()
            final_obs = ts.obs.cpu().numpy().astype(np.float32)
            for j in np.nonzero(done)[0]:
                d = {
                    "episode_returns": self._ep_ret[j].copy(),
                    "episode_length": int(self._ep_len[j]),
                    "episode_time": now - self._ep_t0[j],
                }
                for i in range(self.n_agents):
                    d[f"agent{i}/episode_returns"] = float(self._ep_ret[j, i])
                final_info[j] = d
                final_observation[j] = tuple(final_obs[j, i, : self._obs_dims[i]] for i in range(self.n_agents))
                self._ep_ret[j] = 0.0
                self._ep_len[j] = 0
                self._ep_t0[j] = now
            info["final_info"] = _object_array(final_info)
            info["final_observation"] = _object_array(final_observation)
        return self._obs_tuple(obs), reward, terminated.astype(np.bool_), truncated.astype(np.bool_), info

    def close(self):
        pass


class SyncVectorEnv:
    """Synchronous vector env over single-env thunks with gymnasium<1.0
    autoreset semantics: `step(actions)` takes the actions agent-major (a
    length-`n_agents` sequence of per-env action vectors), returns
    tuple-of-batched observations, and resets a finished sub-env in the
    same call (`final_info`, `final_observation`)."""

    def __init__(self, env_fns: Sequence[Callable[[], object]]):
        _require_gymnasium("SyncVectorEnv")
        self.envs: List[object] = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        e0 = self.envs[0]
        self.single_observation_space = e0.observation_space
        self.single_action_space = e0.action_space
        self.observation_space = _spaces.Tuple([
            _spaces.Box(-np.inf, np.inf, shape=(self.num_envs,) + s.shape, dtype=s.dtype)
            for s in e0.observation_space
        ])
        self.action_space = _spaces.Tuple([_spaces.MultiDiscrete([a.n] * self.num_envs) for a in e0.action_space])
        self.n_agents = len(e0.observation_space)

    def _batch_obs(self, per_env_obs):
        # a list over envs of tuples over agents -> a tuple over agents of (B, d)
        return tuple(np.stack([obs[i] for obs in per_env_obs]).astype(np.float32) for i in range(self.n_agents))

    def _merge_infos(self, per_env_infos):
        info = {}
        if any("action_mask" in i for i in per_env_infos):
            info["action_mask"] = np.stack([i["action_mask"] for i in per_env_infos]).astype(np.float32)
        return info

    def reset(self, *, seed=None, options=None):
        seeds = [None] * self.num_envs if seed is None else [int(seed) + i for i in range(self.num_envs)]
        results = [e.reset(seed=s) for e, s in zip(self.envs, seeds)]
        return self._batch_obs([r[0] for r in results]), self._merge_infos([r[1] for r in results])

    def step(self, actions):
        per_env_actions = list(zip(*actions))  # agent-major -> env-major
        obs_out, rewards, terms, truncs, infos = [], [], [], [], []
        final_info = [None] * self.num_envs
        final_obs = [None] * self.num_envs
        any_done = False
        for j, env in enumerate(self.envs):
            obs, rew, term, trunc, info = env.step(per_env_actions[j])
            if term or trunc:
                any_done = True
                final_info[j] = info
                final_obs[j] = obs
                obs, info = env.reset()
            obs_out.append(obs)
            rewards.append(rew)
            terms.append(term)
            truncs.append(trunc)
            infos.append(info)
        info = self._merge_infos(infos)
        if any_done:
            info["final_info"] = _object_array(final_info)
            info["final_observation"] = _object_array(final_obs)
        return (
            self._batch_obs(obs_out),
            np.asarray(rewards, dtype=np.float32),  # (B, n_agents)
            np.asarray(terms, dtype=np.bool_),
            np.asarray(truncs, dtype=np.bool_),
            info,
        )

    def close(self):
        for e in self.envs:
            e.close()
