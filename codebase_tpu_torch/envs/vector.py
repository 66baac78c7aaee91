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

Host syncs: the rollout's seed (one a rollout) and the early exit's test
(one a step taken, and the one that stops) are each a `sync/*` span and
counter of `utils/profiling`; the steps the loop ran count as
`rollout/policy_steps`.

Random draws: the rollout (reset, policy, env step) draws from a generator
of its own, seeded by one draw of the caller's, so the caller's generator
ends in the same state whether or not the loop stops early (the JAX package
presplits one key per step, and a skipped step leaves the rest untouched).

The env step: on the card, a rollout that is not a rank's part of a
data-parallel one replays the step as a CUDA graph, one per env and width
(`envs/step_graph.py`), bitwise the eager step; the policy, the masked
writes, the early exit's test and the reset run eagerly around it. The CPU
steps eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from codebase_tpu_torch.envs import step_graph
from codebase_tpu_torch.envs.api import Environment
from codebase_tpu_torch.parallel import mesh
from codebase_tpu_torch.utils import profiling


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


def resolve_early_exit(option, env: Environment, n_envs: int):
    """An `early_exit` value for `n_envs` envs of `env`: "auto" is True for
    E >= 512 when the env can end early (the JAX package's rule), else
    `option` as given. A sweep decides on one unit's E, as the JAX rule
    sees E under vmap."""
    if option == "auto":
        return n_envs >= 512 and env.early_termination_possible
    return option


def collect_episodes(
    env: Environment,
    policy: Callable,
    policy_carry,
    generator: torch.Generator,
    n_envs: int,
    time_limit: int,
    use_proper_termination: bool = False,
    early_exit="auto",
    shard=None,
):
    """Collect one full (padded) episode from each of `n_envs` instances.

    `policy(carry, obs (E, N, D), mask (E, N, A), generator) -> (carry,
    actions (E, N))`; the carry typically holds RNN hiddens and is
    re-initialised by the caller per rollout. `early_exit`: True, False or
    "auto", which stops early only for wide batches (E >= 512) of an env
    that can end before its time limit, the JAX package's rule. Returns
    (Rollout, final carry).

    `shard` (a `parallel.mesh.Shard`) makes this the rank's part of a
    data-parallel rollout: `n_envs` are the rank's envs, every draw inside
    is made at the global shape and sliced (`parallel.mesh.draw`), and the
    early exit stops when no env of any rank runs (one `all_reduce` a
    step), so every rank's generators stay in step.
    """
    graphed = step_graph.graphs_step(generator.device, shard is not None, step_graph.ops_watched())
    graph = step_graph.for_env(env, n_envs, generator.device) if graphed else None
    with mesh.drawing(shard) as shard:
        return _collect(env, policy, policy_carry, generator, n_envs, time_limit, use_proper_termination,
                        resolve_early_exit(early_exit, env, n_envs), shard, graph)


def _collect(env, policy, carry, generator, n_envs, time_limit, use_proper_termination, early_exit, shard,
             graph):
    seed = torch.randint(2**62, (), generator=generator, device=generator.device)
    with profiling.host_sync("sync/rollout_seed"):
        seed = int(seed)
    generator = (graph.generator if graph else torch.Generator(device=generator.device)).manual_seed(seed)
    states, ts = env.reset_batch(generator, n_envs)
    step = graph.start(env, states, ts.action_mask) if graph else step_graph.eager_steps(env, states)
    del states  # the step holds the state from here
    obs0, mask0 = ts.obs, ts.action_mask
    running = torch.ones((n_envs,), dtype=torch.bool, device=ts.obs.device)
    out = {k: [] for k in ("obs", "actions", "rewards", "stat_rewards", "dones", "filled", "action_mask")}
    for _ in range(time_limit):
        if early_exit:
            with profiling.host_sync("sync/early_exit"):
                stop = not shard.any(running)
            if stop:
                break
        carry, actions = policy(carry, ts.obs, ts.action_mask, generator)
        with profiling.span("env/step"):
            ts = step(actions, generator, ts.action_mask)
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
    profiling.count("rollout/policy_steps", len(out["filled"]))
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
