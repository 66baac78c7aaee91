"""Multi-Robot Warehouse (RWARE), batched on one device, env axis last.

The same rules as the JAX package's `envs/rware.py` (env ids
`rware-{tiny,small,medium,large}-{N}ag[-easy|-hard]-v2`):
- grid: shelf blocks two cells wide and `column_height` tall, in
  `shelf_rows` x `shelf_columns` blocks separated by one-cell highways; a
  delivery row at the bottom with two goal cells in the middle;
- agents: a cell and a facing direction; actions NOOP=0, FORWARD=1, LEFT=2,
  RIGHT=3, TOGGLE_LOAD=4; rotations are free, FORWARD moves one cell, a
  loaded agent cannot enter a cell holding a stored shelf;
- movement conflicts: among movers with one target cell the lowest index
  wins; movers blocked by agents that stay stop too (N passes of a fixed
  point);
- TOGGLE_LOAD picks up the stored shelf under an unloaded agent (lowest
  index wins a contested shelf) or puts a carried shelf down on a free
  storage cell;
- delivering a carried requested shelf on a goal cell pays 1 (to the
  delivering agent by default) and the request moves to a uniformly drawn
  shelf that was not requested, one draw per delivering agent in index
  order;
- no terminal state before `max_steps`.

Only the batched path is ported: every state field is `(N, E)`, `(S, E)` or
`(E,)`. The step and observations are integer compare-and-select and match
the JAX package exactly, except the requests drawn after a delivery: those
come from a `torch.Generator` (the same distribution, not the same numbers).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from codebase_tpu_torch.envs.api import Environment, TimeStep, gumbel_argmax
from codebase_tpu_torch.parallel.mesh import draw

NOOP, FORWARD, LEFT, RIGHT, TOGGLE_LOAD = range(5)

SIZES = {  # name -> (shelf_rows, shelf_columns)
    "tiny": (1, 3),
    "small": (2, 3),
    "medium": (2, 5),
    "large": (3, 5),
}


@dataclass
class RWAREBatchState:
    """E env instances in struct-of-arrays, env-axis-last layout."""

    agent_r: torch.Tensor  # (N, E) int32
    agent_c: torch.Tensor  # (N, E) int32
    agent_dir: torch.Tensor  # (N, E) int32: 0 up, 1 down, 2 left, 3 right
    carrying: torch.Tensor  # (N, E) int32 shelf index, -1 if none
    shelf_r: torch.Tensor  # (S, E) int32
    shelf_c: torch.Tensor  # (S, E) int32
    shelf_carried: torch.Tensor  # (S, E) bool
    requested: torch.Tensor  # (S, E) bool
    t: torch.Tensor  # (E,) int32


@dataclass(frozen=True)
class RWARE(Environment):
    shelf_rows: int = 1
    shelf_columns: int = 3
    column_height: int = 8
    num_agents: int = 2
    request_queue_size: int = 2
    sensor_range: int = 1
    max_steps: int = 500
    individual_reward: bool = True

    # ------------------------------------------------------------ geometry

    @property
    def rows(self) -> int:
        return (self.column_height + 1) * self.shelf_rows + 2

    @property
    def cols(self) -> int:
        return 3 * self.shelf_columns + 1

    @property
    def n_shelves(self) -> int:
        return self.shelf_rows * self.shelf_columns * 2 * self.column_height

    @property
    def n_agents(self) -> int:
        return self.num_agents

    @property
    def n_actions(self) -> int:
        return 5

    @property
    def integer_valued_obs(self) -> bool:
        return True  # coords, flags and one-hots: bf16 replay is exact

    @property
    def early_termination_possible(self) -> bool:
        return False  # episodes end only at the fixed horizon (`terminated = t >= max_steps`)

    @property
    def obs_dim(self) -> int:
        w = 2 * self.sensor_range + 1
        return 8 + w * w * 5 + w * w * 2

    def _storage_grid(self) -> np.ndarray:
        """(R, C) bool: True on shelf storage cells."""
        grid = np.zeros((self.rows, self.cols), bool)
        for br in range(self.shelf_rows):
            r0 = br * (self.column_height + 1) + 1
            for bc in range(self.shelf_columns):
                c0 = 3 * bc + 1
                grid[r0 : r0 + self.column_height, c0 : c0 + 2] = True
        return grid

    def _goal_cells(self) -> np.ndarray:
        c = self.cols // 2
        return np.array([[self.rows - 1, c - 1], [self.rows - 1, c]], np.int32)

    def _is_storage(self, r, c):
        """Storage-cell membership in closed form (the cells of
        `_storage_grid`): block rows repeat with period column_height+1 from
        row 1; within each 3-column period, columns 1 and 2 hold shelves."""
        H = self.column_height
        row_ok = (r >= 1) & ((r - 1) % (H + 1) < H) & (r <= self.shelf_rows * (H + 1) - 1)
        return row_ok & (c % 3 != 0)

    # --------------------------------------------------------------- reset

    def reset_batch(self, generator: torch.Generator, n: int):
        """Agents on distinct uniform cells with uniform directions, every
        shelf at its home cell, `request_queue_size` distinct requested
        shelves drawn uniformly."""
        N, S = self.num_agents, self.n_shelves
        dev = generator.device
        i32 = torch.int32
        # the top-k of iid uniforms: a uniform ordered draw without replacement
        def rand(shape):
            return torch.rand(shape, generator=generator, device=dev)

        cells = draw(rand, (self.rows * self.cols, n), 1).topk(N, dim=0).indices
        agent_dir = draw(lambda s: torch.randint(0, 4, s, generator=generator, device=dev, dtype=i32), (N, n), 1)
        req = draw(rand, (S, n), 1).topk(self.request_queue_size, dim=0).indices
        requested = torch.zeros((S, n), dtype=torch.bool, device=dev).scatter_(0, req, True)
        home = torch.as_tensor(np.argwhere(self._storage_grid()).astype(np.int32)).to(dev)  # (S, 2) row-major
        state = RWAREBatchState(
            agent_r=(cells // self.cols).to(i32),
            agent_c=(cells % self.cols).to(i32),
            agent_dir=agent_dir,
            carrying=torch.full((N, n), -1, dtype=i32, device=dev),
            shelf_r=home[:, 0, None].expand(S, n).contiguous(),
            shelf_c=home[:, 1, None].expand(S, n).contiguous(),
            shelf_carried=torch.zeros((S, n), dtype=torch.bool, device=dev),
            requested=requested,
            t=torch.zeros((n,), dtype=i32, device=dev),
        )
        zeros = torch.zeros((n, N), device=dev)
        ts = TimeStep(
            obs=self._make_obs_batch(state),
            reward=zeros,
            stat_reward=zeros,
            terminated=torch.zeros((n,), dtype=torch.bool, device=dev),
            truncated=torch.zeros((n,), dtype=torch.bool, device=dev),
            action_mask=torch.ones((n, N, self.n_actions), device=dev),
        )
        return state, ts

    # ---------------------------------------------------------------- step

    def step_batch(self, state: RWAREBatchState, actions, generator=None, current_mask=None):
        """Batched transition. Deterministic given the actions except the
        requests drawn after a delivery, which take `generator`."""
        del current_mask  # maskless env
        N, S = self.num_agents, self.n_shelves
        R, C = self.rows, self.cols
        a = actions.T.to(torch.int32)  # (N, E)
        E = a.shape[1]
        dev = a.device
        i32 = torch.int32
        sidx = torch.arange(S, dtype=i32, device=dev)[:, None]  # (S, 1)
        earlier = (torch.arange(N, device=dev)[None, :] < torch.arange(N, device=dev)[:, None])[:, :, None]  # j < i

        # --- rotations
        d = state.agent_dir
        left = 2 * (d == 0) + 3 * (d == 1) + 1 * (d == 2)
        right = 3 * (d == 0) + 2 * (d == 1) + 1 * (d == 3)
        agent_dir = torch.where(a == LEFT, left, torch.where(a == RIGHT, right, d)).to(i32)

        # --- forward movement
        dr = (agent_dir == 1).to(i32) - (agent_dir == 0).to(i32)
        dc = (agent_dir == 3).to(i32) - (agent_dir == 2).to(i32)
        tr, tc = state.agent_r + dr, state.agent_c + dc
        in_bounds = (tr >= 0) & (tr < R) & (tc >= 0) & (tc < C)
        trc = tr.clamp(0, R - 1)
        tcc = tc.clamp(0, C - 1)
        loaded = state.carrying >= 0  # (N, E)
        stored = ~state.shelf_carried  # (S, E)
        onto_shelf = (
            (trc[:, None, :] == state.shelf_r[None]) & (tcc[:, None, :] == state.shelf_c[None]) & stored[None]
        ).any(1)  # (N, E)
        valid = in_bounds & (~loaded | ~onto_shelf)
        move = (a == FORWARD) & valid
        tgt_r = torch.where(move, trc, state.agent_r)
        tgt_c = torch.where(move, tcc, state.agent_c)
        tcell = tgt_r * C + tgt_c  # (N, E)

        # contention: among movers with the same target, the lowest index wins
        same = tcell[None, :, :] == tcell[:, None, :]  # (i, j, E)
        move = move & ~(same & move[None, :, :] & earlier).any(1)

        # fixed point: movers blocked by agents that stay stop too
        pcell = state.agent_r * C + state.agent_c
        for _ in range(N):
            stay_cells = torch.where(move, -1, pcell)
            move = move & ~(tcell[:, None, :] == stay_cells[None, :, :]).any(1)
        new_r = torch.where(move, tgt_r, state.agent_r)
        new_c = torch.where(move, tgt_c, state.agent_c)

        # --- toggle load / unload
        toggling = a == TOGGLE_LOAD
        match = (new_r[:, None, :] == state.shelf_r[None]) & (new_c[:, None, :] == state.shelf_c[None]) & stored[None]
        under = torch.where(match, sidx[None], -1).amax(1)  # (N, E) stored shelf under the agent, -1 if none
        pickup = toggling & ~loaded & (under >= 0)
        same_shelf = (under[None, :, :] == under[:, None, :]) & pickup[None, :, :] & earlier
        pickup = pickup & ~same_shelf.any(1)
        putdown = toggling & loaded & self._is_storage(new_r, new_c) & (under < 0)

        carrying = torch.where(pickup, under, state.carrying)
        carrying = torch.where(putdown, -1, carrying)

        picked = (pickup[:, None, :] & (under[:, None, :] == sidx[None])).any(0)  # (S, E)
        put = putdown[:, None, :] & (state.carrying[:, None, :] == sidx[None])  # (N, S, E)
        shelf_carried = (state.shelf_carried | picked) & ~put.any(0)

        # a released shelf lands at the agent's cell; a carried shelf tracks
        # its carrier (each shelf is moved by at most one agent)
        upd = put | ((carrying[:, None, :] == sidx[None]) & (carrying[:, None, :] >= 0))  # (N, S, E)
        any_upd = upd.any(0)
        shelf_r = torch.where(any_upd, (upd * new_r[:, None, :]).sum(0), state.shelf_r)
        shelf_c = torch.where(any_upd, (upd * new_c[:, None, :]).sum(0), state.shelf_c)

        # --- deliveries: a carried requested shelf on a goal cell
        on_goal = torch.zeros_like(move)
        for gr, gc in self._goal_cells():
            on_goal = on_goal | ((new_r == int(gr)) & (new_c == int(gc)))
        holds = carrying[:, None, :] == sidx[None]  # (N, S, E)
        delivered = on_goal & (holds & state.requested[None]).any(1)  # (N, E)
        if self.individual_reward:
            reward = delivered.float()
        else:
            reward = delivered.sum(0, keepdim=True).float().expand(N, E)

        # retire the fulfilled requests, then draw their replacements among
        # the shelves not requested, one per delivering agent in index order
        requested = state.requested & ~(delivered[:, None, :] & holds).any(0)
        for i in range(N):
            new_req = gumbel_argmax(~requested, generator)  # (E,)
            requested = requested | ((sidx == new_req[None, :]) & delivered[i][None, :])

        t = state.t + 1
        new_state = RWAREBatchState(
            agent_r=new_r,
            agent_c=new_c,
            agent_dir=agent_dir,
            carrying=carrying.to(i32),
            shelf_r=shelf_r.to(i32),
            shelf_c=shelf_c.to(i32),
            shelf_carried=shelf_carried,
            requested=requested,
            t=t,
        )
        ts = TimeStep(
            obs=self._make_obs_batch(new_state),
            reward=reward.T.contiguous(),
            stat_reward=reward.T.contiguous(),
            terminated=t >= self.max_steps,
            truncated=torch.zeros((E,), dtype=torch.bool, device=dev),
            action_mask=torch.ones((E, N, self.n_actions), device=dev),
        )
        return new_state, ts

    # ------------------------------------------------------------ observations

    def _make_obs_batch(self, state: RWAREBatchState):
        """(E, N, D) observations: 8 own features [y, x, carrying,
        direction one-hot, on a highway], then for each cell of the sensor
        window (row-major) [has agent, its direction one-hot], then for each
        cell [has shelf, requested]. A carried shelf rides its carrier. All
        window cells are matched at once, a few large ops instead of a
        loop over the cells (the host's launch loop is the cost here)."""
        sr = self.sensor_range
        f32 = torch.float32
        self_feats = torch.stack(
            [
                state.agent_r.to(f32),
                state.agent_c.to(f32),
                (state.carrying >= 0).to(f32),
                (state.agent_dir == 0).to(f32),
                (state.agent_dir == 1).to(f32),
                (state.agent_dir == 2).to(f32),
                (state.agent_dir == 3).to(f32),
                (~self._is_storage(state.agent_r, state.agent_c)).to(f32),
            ],
            dim=1,
        )  # (N, 8, E)
        N, E = state.agent_r.shape
        off = torch.arange(-sr, sr + 1, device=state.agent_r.device)
        dy, dx = off.repeat_interleave(len(off)), off.repeat(len(off))  # (W,) window cells, row-major
        cr = (state.agent_r[:, None, :] + dy[None, :, None])[:, :, None, :]  # (N, W, 1, E)
        cc = (state.agent_c[:, None, :] + dx[None, :, None])[:, :, None, :]
        am = (cr == state.agent_r[None, None]) & (cc == state.agent_c[None, None])  # (N, W, N', E)
        dirs = state.agent_dir[:, None, :] == torch.arange(4, device=off.device)[None, :, None]  # (N', 4, E)
        cells = torch.cat(
            [am.any(2, keepdim=True), (am[:, :, :, None, :] & dirs[None, None]).sum(2)], dim=2
        ).to(f32)  # (N, W, 5, E)
        sm = (cr == state.shelf_r[None, None]) & (cc == state.shelf_c[None, None])  # (N, W, S, E)
        shelves = torch.stack([sm.any(2), (sm & state.requested[None, None]).any(2)], dim=2).to(f32)  # (N, W, 2, E)
        obs = torch.cat([self_feats, cells.reshape(N, -1, E), shelves.reshape(N, -1, E)], dim=1)  # (N, D, E)
        return obs.permute(2, 0, 1).contiguous()

    # ---------------------------------------------------------------- render

    def render_frame(self, state: RWAREBatchState, index: int = 0) -> np.ndarray:
        """The JAX package's frame of env `index`: storage, goals, shelves
        (requested green) and agents (loaded orange), 12-pixel cells."""
        one = {k: v[..., index].cpu().numpy() for k, v in vars(state).items()}
        cell = 12
        img = np.full((self.rows * cell, self.cols * cell, 3), 25, np.uint8)
        storage = self._storage_grid()
        for r in range(self.rows):
            for c in range(self.cols):
                if storage[r, c]:
                    img[r * cell : (r + 1) * cell, c * cell : (c + 1) * cell] = (45, 45, 45)
        for g in self._goal_cells():
            img[g[0] * cell : (g[0] + 1) * cell, g[1] * cell : (g[1] + 1) * cell] = (90, 60, 0)
        for s in range(self.n_shelves):
            if not one["shelf_carried"][s]:
                r, c = one["shelf_r"][s], one["shelf_c"][s]
                color = (0, 160, 0) if one["requested"][s] else (0, 80, 120)
                img[r * cell + 2 : (r + 1) * cell - 2, c * cell + 2 : (c + 1) * cell - 2] = color
        for a in range(self.num_agents):
            r, c = one["agent_r"][a], one["agent_c"][a]
            color = (220, 120, 0) if one["carrying"][a] >= 0 else (200, 200, 200)
            img[r * cell + 3 : (r + 1) * cell - 3, c * cell + 3 : (c + 1) * cell - 3] = color
        return img


def parse_rware_name(name: str) -> RWARE:
    """`rware[:rware]-{size}-{N}ag[-easy|-hard]-v{K}`, e.g.
    `rware:rware-tiny-2ag-v2`. The request queue holds N shelves, 2N with
    `-easy`, max(1, N // 2) with `-hard`."""
    parts = name.split(":")[-1].split("-")
    if parts[0] != "rware":
        raise ValueError(f"not an rware id: {name}")
    size = parts[1]
    if size not in SIZES:
        raise ValueError(f"unknown rware size {size!r}; sizes: {sorted(SIZES)}")
    n_agents = int(parts[2].rstrip("ag"))
    queue = n_agents
    if "easy" in parts:
        queue = 2 * n_agents
    elif "hard" in parts:
        queue = max(1, n_agents // 2)
    shelf_rows, shelf_columns = SIZES[size]
    return RWARE(shelf_rows=shelf_rows, shelf_columns=shelf_columns, num_agents=n_agents, request_queue_size=queue)
