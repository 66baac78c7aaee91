"""Persistent streaming reward standardisation.

One stream of running reward moments (West's weighted incremental algorithm,
unit weights) per env instance and agent, kept in the train state for the
whole run and updated exactly once per filled step, as the JAX package's
`RewardStream` is. `standardisation_plan` (`envs/wrappers.py`) finds the
`StandardiseReward` marker in a wrapper stack and splits the
reward-transforming wrappers into those below it (they rebuild the stream's
input from the raw rewards) and those above it (re-applied to its output).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RewardStream:
    sumw: torch.Tensor  # (E, N) total weight == samples seen
    wmean: torch.Tensor  # (E, N) running mean
    tvar: torch.Tensor  # (E, N) running sum of squared deviations
    n: torch.Tensor  # (E,) samples seen per env instance

    @staticmethod
    def init(n_envs: int, n_agents: int, device="cpu") -> "RewardStream":
        z = torch.zeros((n_envs, n_agents), device=device)
        return RewardStream(sumw=z, wmean=z, tvar=z, n=torch.zeros((n_envs,), device=device))


def stream_update(stream: RewardStream, reward: torch.Tensor):
    """One streaming update and standardisation of an (E, N) reward batch.

    The first sample of a stream passes through raw; after that the reward
    is standardised with the post-update moments."""
    q = reward - stream.wmean
    temp_sumw = stream.sumw + 1.0
    r = q / temp_sumw
    wmean = stream.wmean + r
    tvar = stream.tvar + q * r * stream.sumw
    n = stream.n + 1.0
    var = (tvar * n[:, None]) / (temp_sumw * torch.clamp(n - 1.0, min=1e-9)[:, None])
    std = (reward - wmean) / (torch.sqrt(torch.clamp(var, min=0.0)) + 1e-6)
    out = torch.where((n <= 1.0)[:, None], reward, std)
    return RewardStream(sumw=temp_sumw, wmean=wmean, tvar=tvar, n=n), out


def standardise_rollout(stream: RewardStream, rewards: torch.Tensor, filled: torch.Tensor):
    """Standardise a (T, E, N) reward rollout in time order. Only filled
    steps update a stream, and the output is multiplied by `filled` (T, E).
    Returns (updated stream, standardised rewards)."""
    outs = []
    for t in range(rewards.shape[0]):
        f = filled[t]
        new, out = stream_update(stream, rewards[t])
        live = (f > 0)[:, None]
        stream = RewardStream(
            sumw=torch.where(live, new.sumw, stream.sumw),
            wmean=torch.where(live, new.wmean, stream.wmean),
            tvar=torch.where(live, new.tvar, stream.tvar),
            n=torch.where(f > 0, new.n, stream.n),
        )
        outs.append(out * f[:, None])
    return stream, torch.stack(outs)


def apply_plan(plan, stream: RewardStream, stat_rewards: torch.Tensor, filled: torch.Tensor):
    """Run a `RewardPlan` over a rollout's raw (T, E, N) rewards: the
    transforms below the marker rebuild the standardiser's input, those
    above it (e.g. CooperativeReward's team sum) apply to its output."""
    r = stat_rewards
    for fn in plan.below:
        r = fn(r)
    stream, r = standardise_rollout(stream, r, filled)
    for fn in plan.above:
        r = fn(r)
    return stream, r
