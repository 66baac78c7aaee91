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

The units of a sweep share one buffer of U x S slots, unit u's are slots
u*S .. u*S + S-1. Every unit inserts its E episodes per insert (the envs
of a rollout are unit-major), so `pos` is common, and each unit samples
from its own slots.

Over W ranks of a data-parallel run (`parallel/mesh.py`) the slots are
sharded by env slice: an insert of the E global envs fills global slots
`pos % S .. + E-1` (S a multiple of E), so global slot g holds env g % E,
and rank r keeps the S/W slots of its envs `[r*E/W, (r+1)*E/W)`: global
slot g lives on rank `(g % E) // (E/W)` at local slot
`(g // E) * (E/W) + g % (E/W)`. `replay_add` stays local. `pos` counts
the global episodes, so every rank samples the same global indices; each
gathers the rows it owns into a zero-filled batch and one `all_reduce`
of each field hands every rank the whole batch.
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
    pos: int = 0  # episodes ever added (by each unit), over all ranks
    n_units: int = 1  # U units of S slots each; the tensors hold U * S
    # the ranks the slots are sharded over, this one, and the global envs
    # an insert adds (W > 1 only)
    world: int = 1
    rank: int = 0
    n_envs: int = 0

    @property
    def size(self) -> int:
        """Slots of one unit, over all ranks."""
        return self.obs.shape[0] // self.n_units * self.world

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
    n_units: int = 1,
    shard=None,
    n_envs: int = 0,
) -> ReplayState:
    """`size` slots for each of `n_units` units; with a `shard` that splits
    the envs, this rank's `size / W` of them, for inserts of `n_envs`
    global envs (a multiple of W dividing `size`)."""
    world = shard.world if shard is not None and shard.splits_envs else 1
    if world > 1:
        shard.local(n_envs, "parallel_envs")
        if size % n_envs:
            raise ValueError(f"replay of {size} episodes is not a multiple of the {n_envs} envs an insert adds")
    S, T, N, D, A = size // world * n_units, time_limit, n_agents, obs_dim, n_actions
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
        n_units=n_units,
        world=world,
        rank=shard.rank if world > 1 else 0,
        n_envs=n_envs if world > 1 else 0,
    )


def replay_add(state: ReplayState, rollout: Rollout, slot_reuse: str = "reference") -> ReplayState:
    """Insert E padded episodes (time-major rollout -> episode-major slots),
    in place; with U units, U*E unit-major episodes, E into each unit's
    slots. Over W ranks the rollout is this rank's E/W envs, written to its
    own slots.

    slot_reuse — what happens to a slot's old contents past the new episode's
    end (`t > len`):
    - "reference" (default): keep them, `filled` tail included, as the
      reference's ring buffer does (it writes only the new episode's
      indices); needed for learning-curve parity with it;
    - "clear": the padded rollout overwrites the whole slot.
    """
    if slot_reuse not in ("reference", "clear"):
        raise ValueError(f"slot_reuse must be 'reference' or 'clear'; got {slot_reuse!r}")
    U, W = state.n_units, state.world
    S = state.size // W  # this rank's slots of a unit
    E = rollout.filled.shape[1] // U  # this rank's envs of a unit
    device = state.obs.device
    # `pos` is a multiple of the global E, so pos / W is this rank's cursor
    slots = ((state.pos // W + torch.arange(E, device=device)) % S
             + S * torch.arange(U, device=device)[:, None]).reshape(-1)

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
    state.pos += E * W
    return state


def replay_sample_many(state: ReplayState, generator: torch.Generator, batch_size: int, n: int, shard=None):
    """Draw `n` independent uniform batches (with replacement) in ONE gather,
    each unit's from its own slots.

    Leaves keep the gathered slot-major layout with a leading n axis — obs
    (n, U*B, T+1, N, D), actions (n, U*B, T, N), dones (n, U*B, T+1), ...,
    the U units' B episodes unit-major — and `batch_to_reference_layout`
    lays out one update's slice.

    With a `shard` the indices are drawn at the global shape (the same on
    every rank when the envs are split; a sweep rank's units' rows of the
    whole group's draw when the units are), and over W ranks the batch is
    gathered from the ranks that own its slots: every rank gets the whole
    batch."""
    U, device = state.n_units, state.obs.device

    def randint(shape):
        return torch.randint(0, state.num_stored, shape, generator=generator, device=device)

    idx = randint((U, n * batch_size)) if shard is None else shard.draw(randint, (U, n * batch_size), None, 0)
    if U > 1:
        idx = idx + state.size * torch.arange(U, device=device)[:, None]
        idx = idx.reshape(U, n, batch_size).transpose(0, 1)
    if state.world > 1:
        return gather_sharded(state, idx.reshape(-1), batch_size, n, shard)
    return gather_batches(state, idx.reshape(-1), U * batch_size, n)


def gather_sharded(state: ReplayState, idx, batch_size: int, n: int, shard):
    """`gather_batches` of global slot indices over W ranks: each rank
    gathers the rows whose slots it owns into a zero-filled batch, and one
    `all_reduce` of each field sums them (adding zeros is exact)."""
    E, W = state.n_envs, state.world
    El = E // W
    env = idx % E
    own = env // El == state.rank
    local = torch.where(own, idx // E * El + env % El, 0)
    out = gather_batches(state, local, batch_size, n)
    own = own.reshape(n, batch_size)
    for k, v in out.items():
        if v is not None:
            keep = own.reshape(own.shape + (1,) * (v.ndim - 2))
            out[k] = shard.all_reduce(torch.where(keep, v, torch.zeros((), dtype=v.dtype, device=v.device)),
                                      kind="batch")
    return out


def gather_batches(state: ReplayState, idx, batch_size: int, n: int):
    """The gather of `replay_sample_many` on given slot indices (n*B,), B
    rows an update (U*B for U units)."""

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


def batch_to_reference_layout(b: dict, n_units: int = 1) -> dict:
    """One update's slot-major slice -> the reference `Batch` layout:
    obss (N, T+1, B, D), actions (N, T, B), rewards (N, T, B),
    dones (T+1, B), filled (T, B), action_mask (N, T+1, B, A).

    For U units (the slice holds U*B rows, unit-major) the units fold into
    the agent axis, U*N, and dones and filled take a leading unit axis:
    (U, T+1, B) and (U, T, B)."""
    U = n_units
    lead = (U,) if U > 1 else ()

    def agents(x):  # (U*B, T', N, ...) -> (U*N, T', B, ...)
        x = x.reshape((U, -1) + x.shape[1:]).transpose(1, 3)
        return x.reshape((U * x.shape[1],) + x.shape[2:])

    def steps(x):  # (U*B, T') -> (U, T', B)
        return x.reshape(U, -1, x.shape[-1]).transpose(1, 2).reshape(lead + (x.shape[-1], -1))

    return dict(
        obss=agents(b["obss"]).float(),
        actions=agents(b["actions"]),
        rewards=agents(b["rewards"]),
        dones=steps(b["dones"]),
        filled=steps(b["filled"]),
        action_mask=agents(b["action_mask"]).float() if b["action_mask"] is not None else None,
    )
