"""Repeated two-player matrix games, batched on one device: tiny
cooperative envs with known optimal joint actions, as in the JAX package's
`envs/matrix.py`. Both agents see a constant observation 1, get the shared
payoff of their joint action, and the episode ends after `episode_length`
steps."""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from codebase_tpu_torch.envs.api import Environment, TimeStep

PAYOFF_MATRICES = {
    # independent learners can solve this one greedily
    "coordination": ((1.0, 0.0), (0.0, 0.5)),
    # the climbing game (hard for independent learners)
    "climbing": ((11.0, -30.0, 0.0), (-30.0, 7.0, 0.0), (0.0, 0.0, 5.0)),
    "penalty": ((10.0, 0.0, -10.0), (0.0, 2.0, 0.0), (-10.0, 0.0, 10.0)),
}


@dataclass
class MatrixBatchState:
    t: torch.Tensor  # (E,) int32


@dataclass(frozen=True)
class MatrixGame(Environment):
    """Two-player repeated matrix game with a shared reward."""

    payoffs: Tuple[Tuple[float, ...], ...] = PAYOFF_MATRICES["coordination"]
    episode_length: int = 1

    @property
    def n_agents(self) -> int:
        return 2

    @property
    def obs_dim(self) -> int:
        return 1

    @property
    def n_actions(self) -> int:
        return len(self.payoffs)

    @property
    def integer_valued_obs(self) -> bool:
        return True  # constant observation

    @functools.lru_cache(maxsize=16)
    def _table(self, device: torch.device) -> torch.Tensor:
        """The payoff matrix on `device`, copied there once."""
        return torch.tensor(self.payoffs, dtype=torch.float32).to(device)

    def _timestep(self, E, reward, terminated, dev):
        return TimeStep(
            obs=torch.ones((E, 2, 1), device=dev),
            reward=reward,
            stat_reward=reward,
            terminated=terminated,
            truncated=torch.zeros((E,), dtype=torch.bool, device=dev),
            action_mask=torch.ones((E, 2, self.n_actions), device=dev),
        )

    def reset_batch(self, generator: torch.Generator, n: int):
        dev = generator.device
        no = torch.zeros((n,), dtype=torch.bool, device=dev)
        return MatrixBatchState(t=torch.zeros((n,), dtype=torch.int32, device=dev)), self._timestep(
            n, torch.zeros((n, 2), device=dev), no, dev)

    def step_batch(self, state: MatrixBatchState, actions, generator=None, current_mask=None):
        """actions (E, 2): the row player's and the column player's choice."""
        del generator, current_mask
        dev = actions.device
        r = self._table(dev)[actions[:, 0].long(), actions[:, 1].long()]  # (E,)
        t = state.t + 1
        return MatrixBatchState(t=t), self._timestep(
            actions.shape[0], r[:, None].expand(-1, 2).contiguous(), t >= self.episode_length, dev)


def parse_matrix_name(name: str) -> MatrixGame:
    """`matrix-<game>[-<episode_length>]`, e.g. `matrix-climbing-5`."""
    parts = name.split(":")[-1].split("-")
    if parts[0] != "matrix":
        raise ValueError(f"not a matrix game id: {name}")
    game = parts[1] if len(parts) > 1 else "coordination"
    if game not in PAYOFF_MATRICES:
        raise ValueError(f"unknown matrix game {game!r}; games: {sorted(PAYOFF_MATRICES)}")
    length = int(parts[2]) if len(parts) > 2 else 1
    return MatrixGame(payoffs=PAYOFF_MATRICES[game], episode_length=length)
