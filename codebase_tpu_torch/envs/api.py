"""Batched multi-agent environment API.

An environment is a static spec object with two batched functions over
tensors on one device:

    state, ts = env.reset_batch(generator, n)
    state, ts = env.step_batch(state, actions, generator)

Conventions (E envs, N agents), as in the JAX package's batched interface:
- `actions`: (E, N) int64.
- `TimeStep.obs`: (E, N, obs_dim) float32.
- `TimeStep.reward` / `stat_reward`: (E, N) float32 — the reward the learner
  trains on, and the raw env reward used for episode statistics.
- `TimeStep.terminated` / `truncated`: (E,) bool.
- `TimeStep.action_mask`: (E, N, n_actions) float32; all ones when the env
  does not mask (`has_action_mask`).
The batched `state` is an object the env chooses (LBF keeps it env-axis-last).
Random draws come from an explicit `torch.Generator` on the env's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass
class TimeStep:
    obs: torch.Tensor  # (E, N, D) float32
    reward: torch.Tensor  # (E, N) float32
    stat_reward: torch.Tensor  # (E, N) float32
    terminated: torch.Tensor  # (E,) bool
    truncated: torch.Tensor  # (E,) bool
    action_mask: torch.Tensor  # (E, N, A) float32

    @property
    def done(self):
        return self.terminated | self.truncated


class Environment:
    """Static environment spec. Subclasses are frozen dataclasses."""

    @property
    def n_agents(self) -> int:
        raise NotImplementedError

    @property
    def obs_dim(self) -> int:
        raise NotImplementedError

    @property
    def n_actions(self) -> int:
        raise NotImplementedError

    @property
    def has_action_mask(self) -> bool:
        return False

    @property
    def obs_dims(self) -> Tuple[int, ...]:
        return (self.obs_dim,) * self.n_agents

    @property
    def action_dims(self) -> Tuple[int, ...]:
        return (self.n_actions,) * self.n_agents

    def reset_batch(self, generator: torch.Generator, n: int):
        """(generator, n) -> (batched state, TimeStep with leading env axis n)
        on the generator's device."""
        raise NotImplementedError

    def step_batch(self, state, actions, generator=None, current_mask=None):
        """(batched state, (E, N) actions, generator) -> (batched state,
        TimeStep). `current_mask` is the caller's mask of `state`; envs may
        use it to skip recomputing availability, it never changes results."""
        raise NotImplementedError

    @property
    def integer_valued_obs(self) -> bool:
        """True when every observation entry is a small integer, so bf16
        replay storage is lossless."""
        return False

    @property
    def early_termination_possible(self) -> bool:
        """False when episodes can only end at the env's fixed horizon
        (RWARE). The early-exit collector could then never stop before the
        time limit, so `early_exit="auto"` does not check. True by default
        (LBF ends when the food is collected, SMAClite on elimination)."""
        return True


def gumbel_argmax(allowed: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Uniform choice among the allowed rows of each column: argmax of
    Gumbel noise over the allowed cells. allowed (K, E) bool -> (E,) int64."""
    g = -torch.log(torch.empty(allowed.shape, device=allowed.device).exponential_(generator=generator))
    return torch.where(allowed, g, float("-inf")).argmax(0)
