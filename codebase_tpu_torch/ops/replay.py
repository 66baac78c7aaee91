"""Episodic replay buffer held in device memory.

Layout is episode-major (S slots), as in the JAX package: obs (S, T+1, N, D),
actions/rewards (S, T, N), dones (S, T+1), filled (S, T), action_mask
(S, T+1, N, A) or None for envs without masks. `pos` counts episodes ever
added; the write cursor is `pos % S`.

Unlike the JAX package's immutable pytree, `replay_add` writes into the
buffer's tensors in place (one buffer lives for the whole run; a copy per
insert would double its memory traffic) and returns the same state object.

obs and action_mask are stored in `obs_dtype` and cast to float32 when a
batch is laid out for the loss; `build_train_functions` picks bfloat16 when the env
declares `integer_valued_obs`, which bf16 stores exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from codebase_tpu_torch.envs.vector import Rollout


@dataclass
class ReplayState:
    obs: torch.Tensor  # (S, T+1, N, D)
    actions: torch.Tensor  # (S, T, N) int64
    rewards: torch.Tensor  # (S, T, N)
    dones: torch.Tensor  # (S, T+1)
    filled: torch.Tensor  # (S, T)
    action_mask: Optional[torch.Tensor]  # (S, T+1, N, A), None for maskless envs
    pos: int = 0  # episodes ever added

    @property
    def size(self) -> int:
        return self.obs.shape[0]

    @property
    def num_stored(self) -> int:
        return min(self.pos, self.size)

    def can_sample(self, batch_size: int) -> bool:
        return self.pos >= batch_size


def replay_init(
    size: int,
    time_limit: int,
    n_agents: int,
    obs_dim: int,
    n_actions: int,
    with_mask: bool = True,
    obs_dtype=torch.float32,
    device="cpu",
) -> ReplayState:
    S, T, N, D, A = size, time_limit, n_agents, obs_dim, n_actions
    return ReplayState(
        obs=torch.zeros((S, T + 1, N, D), dtype=obs_dtype, device=device),
        actions=torch.zeros((S, T, N), dtype=torch.int64, device=device),
        rewards=torch.zeros((S, T, N), device=device),
        dones=torch.zeros((S, T + 1), device=device),
        filled=torch.zeros((S, T), device=device),
        action_mask=(
            torch.ones((S, T + 1, N, A), dtype=obs_dtype, device=device) if with_mask else None
        ),
        pos=0,
    )


def replay_add(state: ReplayState, rollout: Rollout, slot_reuse: str = "reference") -> ReplayState:
    """Insert E padded episodes (time-major rollout -> episode-major slots),
    in place.

    slot_reuse — what happens to a slot's old contents past the new episode's
    end (`t > len`):
    - "reference" (default): keep them, `filled` tail included, as the
      reference's ring buffer does (it writes only the new episode's
      indices); needed for learning-curve parity with it;
    - "clear": the padded rollout overwrites the whole slot.
    """
    if slot_reuse not in ("reference", "clear"):
        raise ValueError(f"slot_reuse must be 'reference' or 'clear'; got {slot_reuse!r}")
    E = rollout.filled.shape[1]
    S = state.size
    slots = (state.pos + torch.arange(E, device=state.obs.device)) % S

    fil = rollout.filled.transpose(0, 1)  # (E, T)
    written_t = fil > 0
    written_t1 = torch.cat([torch.ones_like(written_t[:, :1]), written_t], dim=1)  # (E, T+1)

    def ins(buf, val):
        val = val.transpose(0, 1).to(buf.dtype)  # time-major -> episode-major
        if slot_reuse == "reference":
            w = written_t if val.shape[1] == fil.shape[1] else written_t1
            w = w.reshape(w.shape + (1,) * (buf.ndim - 2))
            val = torch.where(w, val, buf[slots])
        buf[slots] = val

    ins(state.obs, rollout.obs)
    ins(state.actions, rollout.actions)
    ins(state.rewards, rollout.rewards)
    ins(state.dones, rollout.dones)
    ins(state.filled, rollout.filled)
    if state.action_mask is not None:
        ins(state.action_mask, rollout.action_mask)
    state.pos += E
    return state


def replay_sample_many(state: ReplayState, generator: torch.Generator, batch_size: int, n: int):
    """Draw `n` independent uniform batches (with replacement) in ONE gather.

    Leaves keep the gathered slot-major layout with a leading n axis — obs
    (n, B, T+1, N, D), actions (n, B, T, N), dones (n, B, T+1), ... — and
    `batch_to_reference_layout` lays out one update's slice."""
    idx = torch.randint(
        0, state.num_stored, (n * batch_size,), generator=generator, device=state.obs.device
    )
    return gather_batches(state, idx, batch_size, n)


def gather_batches(state: ReplayState, idx, batch_size: int, n: int):
    """The gather of `replay_sample_many` on given slot indices (n*B,)."""

    def take(buf):
        g = buf[idx]
        return g.reshape((n, batch_size) + g.shape[1:])

    return dict(
        obss=take(state.obs),
        actions=take(state.actions),
        rewards=take(state.rewards),
        dones=take(state.dones),
        filled=take(state.filled),
        action_mask=take(state.action_mask) if state.action_mask is not None else None,
    )


def batch_to_reference_layout(b: dict) -> dict:
    """One update's slot-major slice -> the reference `Batch` layout:
    obss (N, T+1, B, D), actions (N, T, B), rewards (N, T, B),
    dones (T+1, B), filled (T, B), action_mask (N, T+1, B, A)."""
    return dict(
        obss=b["obss"].permute(2, 1, 0, 3).float(),
        actions=b["actions"].permute(2, 1, 0),
        rewards=b["rewards"].permute(2, 1, 0),
        dones=b["dones"].permute(1, 0),
        filled=b["filled"].permute(1, 0),
        action_mask=(
            b["action_mask"].permute(2, 1, 0, 3).float() if b["action_mask"] is not None else None
        ),
    )
