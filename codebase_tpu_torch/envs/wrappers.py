"""Wrapper combinators over the batched `Environment` API.

The order of application is the JAX package's: base -> TimeLimit ->
ObserveID -> StandardiseReward -> named wrappers (e.g. CooperativeReward).
Episode statistics come from `TimeStep.stat_reward`, which every reward
wrapper leaves raw, so `RecordEpisodeStatistics` and `ClearInfo` are the
identity here.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from codebase_tpu_torch.envs.api import Environment


@dataclass(frozen=True)
class WrapperBase(Environment):
    env: Environment

    # reward-transforming wrappers override this with a function of a
    # (..., N) reward tensor; `standardisation_plan` re-orders these around
    # the StandardiseReward marker
    reward_transform = None

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
        # ObserveID prepends 0/1 one-hots and the reward wrappers leave obs
        # as they are, so integrality is the base env's
        return self.env.integer_valued_obs

    @property
    def early_termination_possible(self):
        return self.env.early_termination_possible

    def reset_batch(self, generator, n):
        return self.env.reset_batch(generator, n)

    def step_batch(self, state, actions, generator=None, current_mask=None):
        return self.env.step_batch(state, actions, generator, current_mask)


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


@dataclass(frozen=True)
class ObserveID(WrapperBase):
    """Prepend a one-hot agent id to each agent's observation."""

    @property
    def obs_dim(self):
        return self.env.obs_dim + self.env.n_agents

    def _augment(self, ts):
        n = self.env.n_agents
        eye = torch.eye(n, dtype=ts.obs.dtype, device=ts.obs.device).expand(ts.obs.shape[:-1] + (n,))
        return replace(ts, obs=torch.cat([eye, ts.obs], dim=-1))

    def reset_batch(self, generator, n):
        s, ts = self.env.reset_batch(generator, n)
        return s, self._augment(ts)

    def step_batch(self, state, actions, generator=None, current_mask=None):
        s, ts = self.env.step_batch(state, actions, generator, current_mask)
        return s, self._augment(ts)


@dataclass(frozen=True)
class CooperativeReward(WrapperBase):
    """Replace each agent's reward with the team sum. `stat_reward` stays
    raw, so episode returns are the per-agent env rewards."""

    def reward_transform(self, reward):
        return reward.sum(-1, keepdim=True).expand(reward.shape)

    def step_batch(self, state, actions, generator=None, current_mask=None):
        s, ts = self.env.step_batch(state, actions, generator, current_mask)
        return s, replace(ts, reward=self.reward_transform(ts.reward))


@dataclass(frozen=True)
class StandardiseReward(WrapperBase):
    """Marker of the reward-standardisation point in the wrapper stack; a
    passthrough. The train loop finds it with `standardisation_plan` and
    keeps a persistent per-env `RewardStream` (`ops/reward_stream.py`) in
    its state, updated once per filled step."""


@dataclass(frozen=True)
class FlattenObservation(WrapperBase):
    """Accepted for config compatibility; every env here already emits flat
    (E, N, D) observations, so this is the identity."""


@dataclass(frozen=True)
class RewardPlan:
    """Reward transforms around a StandardiseReward marker, innermost first:
    `below` rebuilds the standardiser's input from the raw `stat_reward`s,
    `above` applies the outer transforms to its output."""

    below: tuple
    above: tuple


def standardisation_plan(env):
    """A `RewardPlan` if `env`'s wrapper stack holds a StandardiseReward
    marker, else None."""
    chain = []  # outermost first
    e = env
    while isinstance(e, WrapperBase):
        chain.append(e)
        e = e.env
    idx = next((i for i, w in enumerate(chain) if isinstance(w, StandardiseReward)), None)
    if idx is None:
        return None
    above = tuple(w.reward_transform for w in reversed(chain[:idx]) if w.reward_transform is not None)
    below = tuple(w.reward_transform for w in reversed(chain[idx + 1 :]) if w.reward_transform is not None)
    return RewardPlan(below=below, above=above)


def _identity_wrapper(env):
    """Names whose effect is built in: episode statistics are always
    recorded by `collect_episodes`, and there is no info dict to clear."""
    return env


NAMED_WRAPPERS = {
    "CooperativeReward": CooperativeReward,
    "ObserveID": ObserveID,
    "StandardiseReward": StandardiseReward,
    "FlattenObservation": FlattenObservation,
    "RecordEpisodeStatistics": _identity_wrapper,
    "ClearInfo": _identity_wrapper,
    "NormalizeReward": StandardiseReward,
}
