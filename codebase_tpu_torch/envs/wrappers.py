"""Wrapper combinators over the batched `Environment` API.

Only `TimeLimit` is ported in this slice; the observation-id and reward
wrappers wait (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from codebase_tpu_torch.envs.api import Environment


@dataclass(frozen=True)
class WrapperBase(Environment):
    env: Environment

    @property
    def n_agents(self):
        return self.env.n_agents

    @property
    def obs_dim(self):
        return self.env.obs_dim

    @property
    def n_actions(self):
        return self.env.n_actions

    @property
    def has_action_mask(self):
        return self.env.has_action_mask

    @property
    def integer_valued_obs(self):
        return self.env.integer_valued_obs


@dataclass
class TimeLimitState:
    inner: object
    t: torch.Tensor  # (E,) int32


@dataclass(frozen=True)
class TimeLimit(WrapperBase):
    """Episode truncation after `limit` steps: sets `truncated`, leaves
    `terminated` as it is."""

    limit: int = 25

    def reset_batch(self, generator, n):
        s, ts = self.env.reset_batch(generator, n)
        return TimeLimitState(inner=s, t=torch.zeros((n,), dtype=torch.int32, device=ts.obs.device)), ts

    def step_batch(self, state, actions, generator=None, current_mask=None):
        s, ts = self.env.step_batch(state.inner, actions, generator, current_mask)
        t = state.t + 1
        truncated = ts.truncated | (t >= self.limit)
        return TimeLimitState(inner=s, t=t), replace(ts, truncated=truncated)
