"""Level-Based Foraging, one episode at a time, in plain Python and NumPy.

The rules of semitable/lb-foraging as the JAX package and its port state
them: simultaneous moves (0 none, 1 north, 2 south, 3 west, 4 east, 5 load);
a move is taken when it stays on the grid and does not enter an active
food's cell; one pass of collision resolution, in which every cell claimed
by more than one player (a player that stays claims its own cell) sends all
its claimants back; each loading player picks the first adjacent active
food in north, south, west, east order; a food is collected when the levels
of the players that picked it sum to at least its level, and each of them
gets `player_level * food_level / (loaders' level sum * food spawned at
reset)`; the episode terminates when no food is left, and a time limit
truncates it.

Observations (`sight` covering the grid): each agent sees the active foods,
row-major, as (row, col, level) relative to its window's origin, empty
slots (-1, -1, 0) up to `max_food`, then every player, in index order.

The state is read back from the first observation of an episode: the
players' cells and levels and the active foods are all in it (`sight`
covers the grid), and the food spawned at reset is the sum of their levels.
"""

from __future__ import annotations

import numpy as np
import torch

NONE, NORTH, SOUTH, WEST, EAST, LOAD = range(6)
MOVES = {NORTH: (-1, 0), SOUTH: (1, 0), WEST: (0, -1), EAST: (0, 1)}
# the order in which a loading player looks for food: north, south, west, east
LOAD_ORDER = ((-1, 0), (1, 0), (0, -1), (0, 1))


class Episode:
    def __init__(self, rows, cols, n_agents, max_food, sight, time_limit, max_episode_steps, obs0):
        self.rows, self.cols, self.n, self.max_food = rows, cols, n_agents, max_food
        self.sight, self.time_limit, self.max_steps = sight, time_limit, max_episode_steps
        o = np.asarray(obs0[0], np.int64)  # agent 0's view; origins are 0 when sight covers the grid
        foods = o[: 3 * max_food].reshape(max_food, 3)
        players = o[3 * max_food:].reshape(n_agents, 3)
        self.players = [[int(r), int(c), int(lvl)] for r, c, lvl in players]
        self.foods = {(int(r), int(c)): int(lvl) for r, c, lvl in foods if lvl > 0}
        self.spawned = float(sum(self.foods.values()))
        self.t = 0

    def reset_faults(self, min_level=1, max_level=3):
        """What in the first observation breaks the reset's rules: players
        on distinct in-grid cells with levels in range; foods inside the
        border, off the players, none in another's 8-neighbourhood, each
        below the sum of the (up to three) lowest player levels."""
        faults = []
        cells = [(r, c) for r, c, _ in self.players]
        if len(set(cells)) != len(cells):
            faults.append("players share a cell")
        for r, c, lvl in self.players:
            if not (0 <= r < self.rows and 0 <= c < self.cols and min_level <= lvl <= max_level):
                faults.append(f"player at {(r, c)} level {lvl}")
        bound = max(sum(sorted(p[2] for p in self.players)[:3]), 2)
        for (r, c), lvl in self.foods.items():
            if not (1 <= r <= self.rows - 2 and 1 <= c <= self.cols - 2) or (r, c) in cells:
                faults.append(f"food at {(r, c)}")
            if not 1 <= lvl < bound:
                faults.append(f"food level {lvl}")
            for (r2, c2) in self.foods:
                if (r2, c2) != (r, c) and abs(r2 - r) <= 1 and abs(c2 - c) <= 1:
                    faults.append(f"foods at {(r, c)} and {(r2, c2)} touch")
        return faults

    def observe(self):
        """(N, 3*max_food + 3*N) observations."""
        out = []
        for r0, c0, _ in self.players:
            orr, occ = max(r0 - self.sight, 0), max(c0 - self.sight, 0)
            row = []
            for (r, c) in sorted(self.foods, key=lambda rc: rc[0] * self.cols + rc[1]):
                if abs(r - r0) <= self.sight and abs(c - c0) <= self.sight:
                    row += [r - orr, c - occ, self.foods[(r, c)]]
            row += [-1, -1, 0] * (self.max_food - len(row) // 3)
            seen = [[r - orr, c - occ, lvl] for r, c, lvl in self.players
                    if abs(r - r0) <= self.sight and abs(c - c0) <= self.sight]
            for triple in seen + [[-1, -1, 0]] * (self.n - len(seen)):
                row += triple
            out.append(row)
        return np.asarray(out, np.float32)

    def step(self, actions):
        """-> (obs (N, D), rewards (N,), done)."""
        targets = []
        for (r, c, _), a in zip(self.players, actions):
            a = int(a)
            if a in MOVES:
                tr, tc = r + MOVES[a][0], c + MOVES[a][1]
                if 0 <= tr < self.rows and 0 <= tc < self.cols and (tr, tc) not in self.foods:
                    targets.append((tr, tc))
                    continue
            targets.append((r, c))
        for i, cell in enumerate(targets):
            if targets.count(cell) == 1:
                self.players[i][0], self.players[i][1] = cell
        picks = {}
        for i, ((r, c, _), a) in enumerate(zip(self.players, actions)):
            if int(a) != LOAD:
                continue
            for dr, dc in LOAD_ORDER:
                if (r + dr, c + dc) in self.foods:
                    picks.setdefault((r + dr, c + dc), []).append(i)
                    break
        rewards = np.zeros(self.n, np.float32)
        for cell, loaders in picks.items():
            total = sum(self.players[i][2] for i in loaders)
            level = self.foods[cell]
            if total >= level:
                for i in loaders:
                    rewards[i] += self.players[i][2] * level / (total * self.spawned)
                del self.foods[cell]
        self.t += 1
        done = not self.foods or self.t >= self.max_steps or self.t >= self.time_limit
        return self.observe(), rewards, done


def check_episodes(env: dict, obs, actions, rewards, dones, filled):
    """Replay padded episodes through the rules and count the entries that
    differ. Episode-major arrays: obs (K, T+1, N, D), actions (K, T, N),
    rewards (K, T, N), dones (K, T+1), filled (K, T). After an episode ends
    its steps hold zeros (filled 0). Returns (mismatches, reset faults,
    first mismatch description or None)."""
    obs, actions = np.asarray(obs, np.float32), np.asarray(actions)
    rewards, dones, filled = (np.asarray(x, np.float32) for x in (rewards, dones, filled))
    K, T = filled.shape
    bad, faults, first = 0, 0, None
    for k in range(K):
        ep = Episode(env["rows"], env["cols"], env["n_agents"], env["max_food"], env["sight"], T,
                     env["max_episode_steps"], obs[k, 0])
        faults += len(ep.reset_faults(env["min_player_level"], env["max_player_level"]))
        want_obs = [ep.observe()]
        want = {"rewards": [], "dones": [0.0], "filled": []}
        running = True
        for t in range(T):
            want["filled"].append(1.0 if running else 0.0)
            if running:
                o, r, done = ep.step(actions[k, t])
                want_obs.append(o)
                want["rewards"].append(r)
                want["dones"].append(1.0 if done else 0.0)
                running = not done
            else:
                want_obs.append(np.zeros_like(want_obs[0]))
                want["rewards"].append(np.zeros(env["n_agents"], np.float32))
                want["dones"].append(0.0)
        checks = {
            "obs": (obs[k], np.stack(want_obs), 0.0),
            # the program's rewards are f32 quotients: equal to rounding
            "rewards": (rewards[k], np.stack(want["rewards"]), 1e-6),
            "dones": (dones[k], np.asarray(want["dones"]), 0.0),
            "filled": (filled[k], np.asarray(want["filled"]), 0.0),
            "padded actions": (actions[k] * (1 - filled[k][:, None]), 0 * actions[k], 0.0),
            "actions out of range": ((actions[k] < 0) | (actions[k] > LOAD), 0 * actions[k], 0.0),
        }
        for name, (got, ref, tol) in checks.items():
            n = int(np.sum(np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)) > tol))
            if n and first is None:
                first = f"episode {k}: {name} differs in {n} entries"
            bad += n
    return bad, faults, first


def _encode(rows, cols, players, foods, active):
    """One observation (every agent's, `sight` covering the grid) of states
    given as tensors: players (M, N, 3), foods (M, F, 3), active (M, F) ->
    (M, 3F + 3N): the active foods row-major, (-1, -1, 0) slots after them,
    then the players in index order."""
    key = torch.where(active, foods[..., 0] * cols + foods[..., 1], torch.full_like(foods[..., 0], rows * cols))
    order = key.argsort(dim=1, stable=True)
    sorted_foods = foods.gather(1, order[..., None].expand_as(foods))
    empty = torch.tensor([-1, -1, 0], dtype=foods.dtype, device=foods.device)
    sorted_foods = torch.where(active.gather(1, order)[..., None], sorted_foods, empty)
    return torch.cat([sorted_foods.flatten(1), players.flatten(1)], 1)


def _decode(o, max_food, n_agents):
    """(players (M, N, 3), foods (M, F, 3), active (M, F)) of agent 0's view."""
    o = o.round().long()
    foods = o[:, : 3 * max_food].reshape(-1, max_food, 3)
    return o[:, 3 * max_food:].reshape(-1, n_agents, 3), foods, foods[..., 2] > 0


def _reset_faults(env, players, foods, active):
    """Reset faults of states (M, ...), each env's count: `Episode.reset_faults`
    over a batch."""
    rows, cols, n = env["rows"], env["cols"], env["n_agents"]
    r, c, lvl = players.unbind(-1)
    same = (r[:, :, None] == r[:, None, :]) & (c[:, :, None] == c[:, None, :])
    faults = (same.sum((1, 2)) > n).long()
    faults += ((r < 0) | (r >= rows) | (c < 0) | (c >= cols) | (lvl < env["min_player_level"])
               | (lvl > env["max_player_level"])).sum(1)
    bound = lvl.sort(1).values[:, :3].sum(1).clamp(min=2)[:, None]
    fr, fc, fl = foods.unbind(-1)
    on_player = ((fr[:, :, None] == r[:, None, :]) & (fc[:, :, None] == c[:, None, :])).any(2)
    placed = (fr < 1) | (fr > rows - 2) | (fc < 1) | (fc > cols - 2) | on_player
    faults += (active & placed).sum(1) + (active & ((fl < 1) | (fl >= bound))).sum(1)
    near = ((fr[:, :, None] - fr[:, None, :]).abs() <= 1) & ((fc[:, :, None] - fc[:, None, :]).abs() <= 1)
    near &= active[:, :, None] & active[:, None, :] & ~torch.eye(foods.shape[1], dtype=torch.bool, device=foods.device)
    return faults + near.sum((1, 2))


def _step(env, players, foods, active, actions, spawned, t, time_limit):
    """One step of states (M, ...) under `Episode.step`'s rules: -> (players,
    active, rewards (M, N) float64, done (M,))."""
    rows, cols = env["rows"], env["cols"]
    dev = players.device
    dr = torch.tensor([0, -1, 1, 0, 0, 0], device=dev)[actions]
    dc = torch.tensor([0, 0, 0, -1, 1, 0], device=dev)[actions]
    r, c, lvl = players.unbind(-1)
    fr, fc, fl = foods.unbind(-1)
    tr, tc = r + dr, c + dc
    into_food = (active[:, None, :] & (fr[:, None, :] == tr[..., None]) & (fc[:, None, :] == tc[..., None])).any(2)
    moving = (actions >= NORTH) & (actions <= EAST) & (tr >= 0) & (tr < rows) & (tc >= 0) & (tc < cols) & ~into_food
    tr, tc = torch.where(moving, tr, r), torch.where(moving, tc, c)
    claims = ((tr[:, :, None] == tr[:, None, :]) & (tc[:, :, None] == tc[:, None, :])).sum(2)
    r, c = torch.where(claims == 1, tr, r), torch.where(claims == 1, tc, c)
    chosen = torch.zeros(actions.shape + active.shape[1:], dtype=torch.bool, device=dev)  # (M, N, F)
    found = torch.zeros_like(actions, dtype=torch.bool)
    for ddr, ddc in LOAD_ORDER:
        hit = active[:, None, :] & (fr[:, None, :] == (r + ddr)[..., None]) & (fc[:, None, :] == (c + ddc)[..., None])
        take = (actions == LOAD) & ~found & hit.any(2)
        chosen |= take[..., None] & hit
        found |= take
    total = (chosen * lvl[..., None]).sum(1)  # (M, F)
    collected = active & chosen.any(1) & (total >= fl)
    share = torch.where(collected, fl.double() / (total.clamp(min=1).double() * spawned[:, None]), 0.0)
    rewards = (chosen * share[:, None, :]).sum(2) * lvl.double()
    active = active & ~collected
    done = ~active.any(1) | (t + 1 >= env["max_episode_steps"]) | (t + 1 >= time_limit)
    return torch.stack([r, c, lvl], -1), active, rewards, done


def check_steps(env: dict, obs, actions, rewards, dones, filled, device="cpu"):
    """Every transition of every env against the rules, each from the
    program's own observation before it, in bulk: the whole rollout, where
    `check_episodes` replays a sample one episode at a time. Needs `sight`
    to cover the grid (the state is then all in one observation).
    Episode-major tensors as `check_episodes` takes them. Counts entries
    that differ (the next observation of every agent, rewards, dones, the
    filled steps, padding, actions out of range) and reset faults of the
    first observations. Returns (count, first mismatch description or
    None)."""
    if env["sight"] < max(env["rows"], env["cols"]) - 1:
        raise ValueError("check_steps reads the state from one observation: sight must cover the grid")
    F, N = env["max_food"], env["n_agents"]
    obs = torch.as_tensor(obs).to(device, torch.float32)
    actions = torch.as_tensor(actions).to(device).long()
    rewards, dones, filled = (torch.as_tensor(x).to(device, torch.float64) for x in (rewards, dones, filled))
    K, T = filled.shape
    counts = {}

    def tally(name, n):
        counts[name] = counts.get(name, 0) + int(n)

    players0, foods0, active0 = _decode(obs[:, 0, 0], F, N)
    tally("reset faults", _reset_faults(env, players0, foods0, active0).sum())
    want0 = _encode(env["rows"], env["cols"], players0, foods0, active0).float()
    tally("first obs", (obs[:, 0] != want0[:, None]).sum())
    spawned = (foods0[..., 2] * active0).sum(1).double()  # (K,)

    live = filled.bool()
    want_filled = torch.cat([torch.ones_like(live[:, :1]), live[:, :-1] & (dones[:, 1:-1] == 0)], 1)
    tally("filled", (live != want_filled).sum())
    tally("first done", (dones[:, 0] != 0).sum())
    tally("actions out of range", ((actions < NONE) | (actions > LOAD)).sum())
    dead = ~live
    tally("padded actions", (actions[dead] != 0).sum())
    tally("padded obs", (obs[:, 1:][dead] != 0).sum())
    tally("padded rewards", (rewards[dead] != 0).sum())
    tally("padded dones", (dones[:, 1:][dead] != 0).sum())

    k, t = live.nonzero(as_tuple=True)
    players, foods, active = _decode(obs[k, t, 0], F, N)
    nxt_players, nxt_active, want_r, done = _step(env, players, foods, active, actions[k, t].clamp(NONE, LOAD),
                                                  spawned[k], t, T)
    want_obs = _encode(env["rows"], env["cols"], nxt_players, foods, nxt_active).float()
    tally("obs", (obs[k, t + 1] != want_obs[:, None]).sum())
    # the program's rewards are f32 quotients: equal to rounding
    tally("rewards", ((rewards[k, t] - want_r).abs() > 1e-6).sum())
    tally("dones", (dones[k, t + 1] != done.double()).sum())
    bad = sum(counts.values())
    first = next((f"{name}: {n} entries" for name, n in counts.items() if n), None)
    return bad, first
