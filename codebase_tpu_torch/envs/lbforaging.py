"""Level-Based Foraging, batched on one device, env axis last.

The same rules as the JAX package's `envs/lbforaging.py` (semitable/
lb-foraging semantics: simultaneous moves with a single-pass collision rule,
loading by the first adjacent food in N, S, W, E order, rewards
`player_level * food_level` normalised by `loader_level_sum * spawned food
level`, termination when all food is collected or at `max_episode_steps`).

Only the batched, env-axis-last path is ported: every state field is
`(N, E)`, `(F, E)` or `(E,)`, and the step and observation build are
integer compare-and-select over those tensors, so they match the JAX package
exactly on the same state and actions. Spawning draws from a
`torch.Generator`: each categorical choice is a Gumbel-argmax over the
allowed cells, the same distribution as the JAX package's draws (not the
same numbers).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as Fnn

from codebase_tpu_torch.envs.api import Environment, TimeStep, gumbel_argmax

NONE, NORTH, SOUTH, WEST, EAST, LOAD = range(6)


@dataclass
class LBFBatchState:
    """E env instances in struct-of-arrays, env-axis-last layout."""

    agent_r: torch.Tensor  # (N, E) int32
    agent_c: torch.Tensor  # (N, E) int32
    agent_level: torch.Tensor  # (N, E) int32
    food_r: torch.Tensor  # (F, E) int32
    food_c: torch.Tensor  # (F, E) int32
    food_level: torch.Tensor  # (F, E) int32
    food_active: torch.Tensor  # (F, E) bool
    food_spawned: torch.Tensor  # (E,) float32
    t: torch.Tensor  # (E,) int32


@dataclass(frozen=True)
class LevelBasedForaging(Environment):
    rows: int = 8
    cols: int = 8
    num_agents: int = 2
    max_food: int = 3
    sight: int = 8
    max_episode_steps: int = 50
    force_coop: bool = False
    normalize_reward: bool = True
    penalty: float = 0.0
    min_player_level: int = 1
    max_player_level: int = 3
    min_food_level: int = 1
    # grid observations (`Foraging-grid-...` ids): each agent's flattened
    # (3, 2*sight+1, 2*sight+1) window of agent levels, food levels and access
    grid_obs: bool = False

    @property
    def n_agents(self) -> int:
        return self.num_agents

    @property
    def obs_dim(self) -> int:
        if self.grid_obs:
            w = 2 * self.sight + 1
            return 3 * w * w
        return 3 * self.max_food + 3 * self.num_agents

    @property
    def n_actions(self) -> int:
        return 6

    @property
    def integer_valued_obs(self) -> bool:
        return True  # coords and levels only -> bf16-exact replay storage

    # ------------------------------------------------------------------ reset

    def reset_batch(self, generator: torch.Generator, n: int):
        state = self._reset_state_batch(generator, n)
        dev = state.t.device
        zeros = torch.zeros((n, self.num_agents), device=dev)
        ts = TimeStep(
            obs=self._make_obs_batch(state),
            reward=zeros,
            stat_reward=zeros,
            terminated=torch.zeros((n,), dtype=torch.bool, device=dev),
            truncated=torch.zeros((n,), dtype=torch.bool, device=dev),
            action_mask=torch.ones((n, self.num_agents, self.n_actions), device=dev),
        )
        return state, ts

    def _reset_state_batch(self, generator: torch.Generator, E: int) -> LBFBatchState:
        R, C, N, F = self.rows, self.cols, self.num_agents, self.max_food
        RC = R * C
        dev = generator.device
        i32 = torch.int32
        cell_iota = torch.arange(RC, device=dev)[:, None]  # (RC, 1)

        # --- players: sequential uniform over empty cells
        occ = torch.zeros((RC, E), dtype=torch.bool, device=dev)
        player_cells = []
        for _ in range(N):
            cell = gumbel_argmax(~occ, generator)
            player_cells.append(cell)
            occ = occ | (cell_iota == cell[None, :])
        player_cells = torch.stack(player_cells)  # (N, E)
        agent_level = torch.randint(
            self.min_player_level, self.max_player_level + 1, (N, E),
            generator=generator, device=dev, dtype=i32,
        )

        # --- foods: interior cells, empty, no food in the 8-neighbourhood
        rr = torch.arange(R, device=dev)[:, None]
        cc = torch.arange(C, device=dev)[None, :]
        interior = ((rr >= 1) & (rr <= R - 2) & (cc >= 1) & (cc <= C - 2))[:, :, None]
        player_grid = occ.view(R, C, E)
        food_grid = torch.zeros((R, C, E), dtype=torch.bool, device=dev)
        food_cells, food_act = [], []
        for _ in range(F):
            padded = Fnn.pad(food_grid.to(i32), (0, 0, 1, 1, 1, 1))
            neigh = sum(
                padded[1 + dr : 1 + dr + R, 1 + dc : 1 + dc + C]
                for dr in (-1, 0, 1)
                for dc in (-1, 0, 1)
            )
            valid = interior & ~player_grid & (neigh == 0)
            any_valid = valid.reshape(RC, E).any(0)  # (E,)
            # no valid cell: the draw is uniform over all cells and the food
            # stays inactive (as the JAX package's all-invalid guard)
            cell = gumbel_argmax(valid.reshape(RC, E) | ~any_valid[None, :], generator)
            onehot = (cell_iota == cell[None, :]).view(R, C, E)
            food_grid = food_grid | (onehot & any_valid[None, None, :])
            food_cells.append(cell)
            food_act.append(any_valid)
        food_cells = torch.stack(food_cells)  # (F, E)
        food_active = torch.stack(food_act)  # (F, E)

        # food level upper bound: sum of the three lowest player levels
        # (exclusive bound), exactly the bound when force_coop
        max_level = agent_level.sort(0).values[: min(3, N)].sum(0)  # (E,)
        if self.force_coop:
            food_level = max_level[None, :].expand(F, E).to(i32)
        else:
            lo = self.min_food_level
            hi = max_level.clamp(min=lo + 1)  # (E,)
            u = torch.rand((F, E), generator=generator, device=dev)
            food_level = lo + torch.minimum(
                (u * (hi - lo)[None, :]).floor().to(i32), (hi - lo - 1)[None, :].to(i32)
            )
        food_level = torch.where(food_active, food_level, 0).to(i32)

        return LBFBatchState(
            agent_r=(player_cells // C).to(i32),
            agent_c=(player_cells % C).to(i32),
            agent_level=agent_level,
            food_r=(food_cells // C).to(i32),
            food_c=(food_cells % C).to(i32),
            food_level=food_level,
            food_active=food_active,
            food_spawned=food_level.sum(0).float(),
            t=torch.zeros((E,), dtype=i32, device=dev),
        )

    # ------------------------------------------------------------------- step

    def step_batch(self, state: LBFBatchState, actions, generator=None, current_mask=None):
        """Batched transition; the dynamics are deterministic given actions."""
        del generator, current_mask
        R, C, N, F = self.rows, self.cols, self.num_agents, self.max_food
        a = actions.T  # (N, E)
        E = a.shape[1]

        dr = (a == SOUTH).int() - (a == NORTH).int()  # (N, E)
        dc = (a == EAST).int() - (a == WEST).int()
        tr, tc = state.agent_r + dr, state.agent_c + dc
        in_bounds = (tr >= 0) & (tr < R) & (tc >= 0) & (tc < C)
        trc = tr.clamp(0, R - 1)
        tcc = tc.clamp(0, C - 1)
        hit_food = (
            (trc[:, None, :] == state.food_r[None])
            & (tcc[:, None, :] == state.food_c[None])
            & state.food_active[None]
        )  # (N, F, E)
        onto_food = hit_food.any(1)
        is_move = (a >= NORTH) & (a <= EAST)
        valid_move = is_move & in_bounds & ~onto_food
        ntr = torch.where(valid_move, trc, state.agent_r)
        ntc = torch.where(valid_move, tcc, state.agent_c)

        # single-pass collision resolution: a cell claimed by more than one
        # player cancels every claim on it
        cell = ntr * C + ntc  # (N, E)
        claims = (cell[:, None, :] == cell[None, :, :]).sum(1)  # (N, E)
        ok = claims == 1
        new_r = torch.where(ok, ntr, state.agent_r)
        new_c = torch.where(ok, ntc, state.agent_c)

        # loading: first adjacent active food per LOADer (N, S, W, E priority)
        loading = a == LOAD  # (N, E)
        fdr = state.food_r[None] - new_r[:, None, :]  # (N, F, E)
        fdc = state.food_c[None] - new_c[:, None, :]
        prio = torch.full((N, F, E), 99, dtype=torch.int32, device=a.device)
        prio = torch.where((fdr == -1) & (fdc == 0), 0, prio)
        prio = torch.where((fdr == 1) & (fdc == 0), 1, prio)
        prio = torch.where((fdr == 0) & (fdc == -1), 2, prio)
        prio = torch.where((fdr == 0) & (fdc == 1), 3, prio)
        prio = torch.where(state.food_active[None] & loading[:, None, :], prio, 99)
        choice = prio.argmin(1)  # (N, E), first minimum
        has_choice = prio.amin(1) < 99
        slot = torch.arange(F, device=a.device)[None, :, None]
        picks = has_choice[:, None, :] & (choice[:, None, :] == slot)  # (N, F, E)
        loader_sum = (picks * state.agent_level[:, None, :]).sum(0)  # (F, E)
        collected = state.food_active & (loader_sum >= state.food_level) & (loader_sum > 0)
        failed = (loader_sum > 0) & ~collected

        lvl_f = state.food_level.float()  # (F, E)
        gain = (
            (picks & collected[None]).float()
            * state.agent_level[:, None, :].float()
            * lvl_f[None]
        )  # (N, F, E)
        if self.normalize_reward:
            denom = (loader_sum.float() * state.food_spawned[None, :]).clamp(min=1e-9)
            gain = gain / denom[None]
        reward = gain.sum(1)  # (N, E)
        if self.penalty:
            reward = reward - self.penalty * (picks & failed[None]).sum(1)

        food_active = state.food_active & ~collected
        t = state.t + 1
        terminated = ~food_active.any(0) | (t >= self.max_episode_steps)  # (E,)

        new_state = replace(
            state,
            agent_r=new_r,
            agent_c=new_c,
            food_active=food_active,
            food_level=torch.where(food_active, state.food_level, 0).to(torch.int32),
            t=t,
        )
        reward = reward.T.contiguous()
        ts = TimeStep(
            obs=self._make_obs_batch(new_state),
            reward=reward,
            stat_reward=reward,
            terminated=terminated,
            truncated=torch.zeros((E,), dtype=torch.bool, device=a.device),
            action_mask=torch.ones((E, N, self.n_actions), device=a.device),
        )
        return new_state, ts

    # ------------------------------------------------------------ observations

    def _make_obs_batch(self, state: LBFBatchState):
        """(E, N, D) observations: the grid window with `grid_obs`, else food
        triples then player triples (see `_make_obs_triples`)."""
        if self.grid_obs:
            return self._make_obs_grid_batch(state)
        return self._make_obs_triples(state)

    def _make_obs_grid_batch(self, state: LBFBatchState):
        """(E, N, 3*(2s+1)^2) grid observations: three layers over the field
        (agent levels, active food levels, and access: 1 on in-bounds cells
        with no agent and no active food), each agent seeing the (2s+1)^2
        window centred on itself, flattened layer-major then row-major; cells
        off the field read 0 in every layer. Each window cell matches the
        agents and foods against its coordinates, so no grid is built."""
        s, R, C = self.sight, self.rows, self.cols
        off = torch.arange(-s, s + 1, device=state.agent_r.device)
        cell_r = (state.agent_r[:, None, :] + off[None, :, None])[:, :, None, None, :]  # (N, w, 1, 1, E)
        cell_c = (state.agent_c[:, None, :] + off[None, :, None])[:, None, :, None, :]  # (N, 1, w, 1, E)
        at_agent = (cell_r == state.agent_r[None, None, None]) & (cell_c == state.agent_c[None, None, None])
        at_food = (
            (cell_r == state.food_r[None, None, None])
            & (cell_c == state.food_c[None, None, None])
            & state.food_active[None, None, None]
        )  # (N, w, w, F, E)
        agent_layer = (at_agent * state.agent_level[None, None, None]).sum(3)  # (N, w, w, E)
        food_layer = (at_food * state.food_level[None, None, None]).sum(3)
        inside = (cell_r >= 0) & (cell_r < R) & (cell_c >= 0) & (cell_c < C)
        access = inside[:, :, :, 0] & ~at_agent.any(3) & ~at_food.any(3)
        N, E = state.agent_r.shape
        obs = torch.stack([agent_layer, food_layer, access], dim=1).float()  # (N, 3, w, w, E)
        return obs.reshape(N, -1, E).permute(2, 0, 1).contiguous()

    def _make_obs_triples(self, state: LBFBatchState):
        """(E, N, D) observations: food triples then player triples (y, x,
        level) relative to the agent's sight-window origin, visible entries
        compacted to the front (foods row-major, players by index), empty
        slots (-1, -1, 0). Sorting is a rank + one-hot permutation over
        unique keys, so it matches a stable argsort exactly."""
        N, F, C = self.num_agents, self.max_food, self.cols
        E = state.agent_r.shape[1]
        dev = state.agent_r.device
        BIG = self.rows * self.cols + 10

        origin_r = (state.agent_r - self.sight).clamp(min=0)  # (N, E)
        origin_c = (state.agent_c - self.sight).clamp(min=0)

        def rank_permute(sort_key, feats):
            """sort_key (N, K, E) with unique keys; feats: (N, K, E) tensors,
            each reordered ascending by key along K."""
            rank = (sort_key[:, :, None, :] > sort_key[:, None, :, :]).sum(2)  # (N, K, E)
            K = sort_key.shape[1]
            slot = torch.arange(K, device=dev)[None, :, None, None]
            perm = rank[:, None, :, :] == slot  # (N, K_out, K_in, E)
            return [(perm * f[:, None, :, :]).sum(2) for f in feats]

        # --- foods: visible & active, row-major order
        vis_f = (
            state.food_active[None]
            & ((state.food_r[None] - state.agent_r[:, None, :]).abs() <= self.sight)
            & ((state.food_c[None] - state.agent_c[:, None, :]).abs() <= self.sight)
        )  # (N, F, E)
        food_cell = (state.food_r * C + state.food_c)[None]  # (1, F, E)
        fidx = torch.arange(F, device=dev)[None, :, None]
        f_key = torch.where(vis_f, food_cell, BIG + fidx)
        f_vis, f_r, f_c, f_lvl = rank_permute(
            f_key,
            [
                vis_f.int(),
                state.food_r[None].expand(N, F, E) - origin_r[:, None, :],
                state.food_c[None].expand(N, F, E) - origin_c[:, None, :],
                state.food_level[None].expand(N, F, E),
            ],
        )
        ok = f_vis > 0
        food_feats = torch.stack(
            [torch.where(ok, f_r, -1), torch.where(ok, f_c, -1), torch.where(ok, f_lvl, 0)],
            dim=2,
        )  # (N, F, 3, E)

        # --- players: visible, index order
        vis_p = ((state.agent_r[None] - state.agent_r[:, None, :]).abs() <= self.sight) & (
            (state.agent_c[None] - state.agent_c[:, None, :]).abs() <= self.sight
        )  # (N, N, E)
        pidx = torch.arange(N, device=dev)[None, :, None]
        p_key = torch.where(vis_p, pidx, BIG + pidx)
        p_vis, p_r, p_c, p_lvl = rank_permute(
            p_key,
            [
                vis_p.int(),
                state.agent_r[None].expand(N, N, E) - origin_r[:, None, :],
                state.agent_c[None].expand(N, N, E) - origin_c[:, None, :],
                state.agent_level[None].expand(N, N, E),
            ],
        )
        okp = p_vis > 0
        player_feats = torch.stack(
            [torch.where(okp, p_r, -1), torch.where(okp, p_c, -1), torch.where(okp, p_lvl, 0)],
            dim=2,
        )  # (N, N, 3, E)

        obs = torch.cat(
            [food_feats.reshape(N, 3 * F, E), player_feats.reshape(N, 3 * N, E)], dim=1
        ).float()  # (N, D, E)
        return obs.permute(2, 0, 1).contiguous()  # (E, N, D)


def parse_lbf_name(name: str) -> LevelBasedForaging:
    """Parse `Foraging[-grid][-{s}s]-{S}x{S}-{P}p-{F}f[-coop][-vK]`
    (optionally prefixed with `lbforaging:`) into an env spec. `-grid`
    selects grid observations, right after "Foraging" as the original
    package registers it, or trailing."""
    base = name.split(":")[-1]
    parts = base.split("-")
    if parts[0] != "Foraging":
        raise ValueError(f"not an lbforaging id: {name}")
    idx = 1
    sight = None
    grid_obs = parts[idx] == "grid"
    if grid_obs:
        idx += 1
    if parts[idx].endswith("s") and parts[idx][:-1].isdigit():  # "Foraging-2s-..."
        sight = int(parts[idx][:-1])
        idx += 1
    rows, cols = (int(v) for v in parts[idx].split("x"))
    idx += 1
    if not parts[idx].endswith("p"):
        raise ValueError(f"not an lbforaging id: {name}")
    players = int(parts[idx][:-1])
    idx += 1
    if not parts[idx].endswith("f"):
        raise ValueError(f"not an lbforaging id: {name}")
    foods = int(parts[idx][:-1])
    idx += 1
    return LevelBasedForaging(
        rows=rows,
        cols=cols,
        num_agents=players,
        max_food=foods,
        sight=sight if sight is not None else max(rows, cols),
        force_coop="coop" in parts[idx:],
        grid_obs=grid_obs or "grid" in parts[idx:],
    )
