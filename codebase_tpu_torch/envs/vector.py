"""Batched episode collection: E envs stepped together, a Python loop over T.

The same semantics as the JAX package's `collect_episodes` (scan path):
- every rollout starts with a fresh `reset_batch`;
- a fixed T = time_limit step loop with a per-env `running` mask;
- finished envs record nothing: after `done`, obs, actions and rewards are
  zero, `filled` is 0 and `action_mask` is ones;
- `dones` stores termination per `use_proper_termination`: when False,
  truncation counts as termination for the learner.
The early-exit variant stops at the first step with no running env and
fills the steps not taken as the loop fills finished envs (zeros, masks of
ones), so its rollout is identical; the returned policy carry is the one at
the stop, as in the JAX package's while_loop. Its test for a running env is
a host sync per step.

Random draws: the rollout (reset, policy, env step) draws from a generator
of its own, seeded by one draw of the caller's, so the caller's generator
ends in the same state whether or not the loop stops early (the JAX package
presplits one key per step, and a skipped step leaves the rest untouched).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch.profiler import record_function

from codebase_tpu_torch.envs.api import Environment


@dataclass
class Rollout:
    """One batch of padded episodes. Shapes: T steps, E envs, N agents."""

    obs: torch.Tensor  # (T+1, E, N, D)
    actions: torch.Tensor  # (T, E, N) int64
    rewards: torch.Tensor  # (T, E, N) training rewards
    stat_rewards: torch.Tensor  # (T, E, N) raw rewards for episode stats
    dones: torch.Tensor  # (T+1, E) float32
    filled: torch.Tensor  # (T, E) float32
    action_mask: torch.Tensor  # (T+1, E, N, A) float32

    @property
    def episode_returns(self):
        """(E, N) per-agent raw episode returns."""
        return (self.stat_rewards * self.filled[..., None]).sum(0)

    @property
    def episode_lengths(self):
        """(E,) episode lengths."""
        return self.filled.sum(0)

    @property
    def env_steps(self):
        """() total environment steps collected."""
        return self.filled.sum()


def collect_episodes(
    env: Environment,
    policy: Callable,
    policy_carry,
    generator: torch.Generator,
    n_envs: int,
    time_limit: int,
    use_proper_termination: bool = False,
    early_exit="auto",
):
    """Collect one full (padded) episode from each of `n_envs` instances.

    `policy(carry, obs (E, N, D), mask (E, N, A), generator) -> (carry,
    actions (E, N))`; the carry typically holds RNN hiddens and is
    re-initialised by the caller per rollout. `early_exit`: True, False or
    "auto", which stops early only for wide batches (E >= 512) of an env
    that can end before its time limit, the JAX package's rule. Returns
    (Rollout, final carry).
    """
    if early_exit == "auto":
        early_exit = n_envs >= 512 and env.early_termination_possible
    seed = torch.randint(2**62, (), generator=generator, device=generator.device)
    generator = torch.Generator(device=generator.device).manual_seed(int(seed))
    states, ts = env.reset_batch(generator, n_envs)
    obs0, mask0 = ts.obs, ts.action_mask
    running = torch.ones((n_envs,), dtype=torch.bool, device=ts.obs.device)
    carry = policy_carry
    out = {k: [] for k in ("obs", "actions", "rewards", "stat_rewards", "dones", "filled", "action_mask")}
    for _ in range(time_limit):
        if early_exit and not bool(running.any()):
            break
        carry, actions = policy(carry, ts.obs, ts.action_mask, generator)
        with record_function("env/step"):  # read by `codebase_tpu_torch.profile`
            states, ts = env.step_batch(states, actions, generator, ts.action_mask)
        done = ts.done  # (E,)
        proper_done = ts.terminated if use_proper_termination else done
        rmask = running.float()
        out["obs"].append(ts.obs * rmask[:, None, None])
        out["actions"].append(actions * running[:, None])
        out["rewards"].append(ts.reward * rmask[:, None])
        out["stat_rewards"].append(ts.stat_reward * rmask[:, None])
        out["dones"].append(proper_done.float() * rmask)
        out["filled"].append(rmask)
        out["action_mask"].append(
            torch.where(running[:, None, None], ts.action_mask, torch.ones_like(ts.action_mask))
        )
        running = running & ~done
    skipped = time_limit - len(out["filled"])  # the steps an early exit did not take
    if skipped:
        for k, steps in out.items():
            steps += [(torch.ones_like if k == "action_mask" else torch.zeros_like)(steps[-1])] * skipped

    rollout = Rollout(
        obs=torch.stack([obs0] + out["obs"]),
        actions=torch.stack(out["actions"]),
        rewards=torch.stack(out["rewards"]),
        stat_rewards=torch.stack(out["stat_rewards"]),
        dones=torch.stack([torch.zeros_like(out["dones"][0])] + out["dones"]),
        filled=torch.stack(out["filled"]),
        action_mask=torch.stack([mask0] + out["action_mask"]),
    )
    return rollout, carry
