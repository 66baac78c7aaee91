"""SMAClite combat (the port's grid form of SMAC), one episode at a time, in
plain NumPy float32.

The rules as the JAX package and its port state them:
- actions: 0 no-op (valid only when dead), 1 stop, 2-5 move north, south,
  west, east, 6+j attack enemy j, or for a medivac heal ally j; an action
  the mask forbids becomes stop;
- an ally that attacks or heals needs a cooldown of 0 and sets it to its
  type's cooldown; otherwise the cooldown counts down to 0; damage to an
  enemy is capped at its hp (no overkill credit);
- scripted enemies act on the allies' new cells: a fighter shoots the
  nearest living ally in range (the first on ties), a medivac heals the
  teammate in range with the largest hp deficit after the allies' damage
  (the first on ties, never itself, a unit killed this step stays dead);
  an enemy that does not act steps one cell towards its nearest ally;
  hp is kept within [0, max hp] and heals never resurrect;
- reward: (damage dealt + kill bonus * kills + win bonus on a win) over the
  maximal reward, the same for every agent (a CooperativeReward wrapper
  hands each agent the team's sum);
- termination: one side eliminated or the env's step limit; a time limit
  truncates;
- observations per agent: own (hp / max hp, cooldown ready, row / rows,
  col / cols, type one-hot), per enemy (visible, relative row and col over
  the map size, hp / max hp, in attack range, type one-hot), per other ally
  in index order (visible, relative row and col, hp / max hp, type
  one-hot); all zero for a dead agent; visibility and ranges by Chebyshev
  distance; the mask: no-op when dead, stop, each move that stays on the
  map, each target in range (a medivac: each damaged living ally in range
  other than itself), all when alive.

Unit stats (max hp, damage or heal, range, cooldown, healer): marine 45 6
4 1, marauder 125 10 5 1, medivac 150 9 4 1 healer (the port's table).
Divisions by a constant are float32 multiplications by its float32
reciprocal, as the port and the JAX package compute them.
"""

from __future__ import annotations

import numpy as np

STATS = {
    "marine": (45.0, 6.0, 4, 1, False),
    "stalker": (160.0, 13.0, 5, 1, False),
    "zealot": (150.0, 16.0, 1, 1, False),
    "marauder": (125.0, 10.0, 5, 1, False),
    "medivac": (150.0, 9.0, 4, 1, True),
}
ORDER = tuple(STATS)
STOP = 1
f32 = np.float32


def recip(x) -> np.ndarray:
    return f32(1.0) / np.asarray(x, f32)


class Scenario:
    def __init__(self, env: dict):
        self.allies, self.enemies = tuple(env["allies"]), tuple(env["enemies"])
        self.rows, self.cols, self.sight = env["rows"], env["cols"], env["sight_range"]
        self.max_steps, self.kill_bonus, self.win_bonus = env["max_steps"], env["kill_bonus"], env["win_bonus"]
        self.N, self.M = len(self.allies), len(self.enemies)
        healer = any(STATS[t][4] for t in self.allies + self.enemies)
        self.n_targets = max(self.M, self.N) if healer else self.M
        self.n_actions = 6 + self.n_targets
        a, e = [STATS[t] for t in self.allies], [STATS[t] for t in self.enemies]
        self.a_maxhp, self.a_dmg = np.array([s[0] for s in a], f32), np.array([s[1] for s in a], f32)
        self.a_range, self.a_cd = np.array([s[2] for s in a]), np.array([s[3] for s in a])
        self.healer = np.array([s[4] for s in a])
        self.e_maxhp, self.e_dmg = np.array([s[0] for s in e], f32), np.array([s[1] for s in e], f32)
        self.e_range, self.e_cd = np.array([s[2] for s in e]), np.array([s[3] for s in e])
        self.e_healer = np.array([s[4] for s in e])
        table = sorted(set(self.allies + self.enemies), key=ORDER.index)
        tb = len(table) if len(table) > 1 else 0
        self.a_hot = np.zeros((self.N, tb), f32)
        self.e_hot = np.zeros((self.M, tb), f32)
        for i, t in enumerate(self.allies):
            if tb:
                self.a_hot[i, table.index(t)] = 1
        for j, t in enumerate(self.enemies):
            if tb:
                self.e_hot[j, table.index(t)] = 1
        self.others = np.array([[n for n in range(self.N) if n != i] for i in range(self.N)]).reshape(self.N, -1)
        self.inv_a, self.inv_e = recip(self.a_maxhp), recip(self.e_maxhp)
        self.inv_r, self.inv_c = recip(float(self.rows)), recip(float(self.cols))
        max_reward = float(self.e_maxhp.astype(np.float64).sum()) + self.M * self.kill_bonus + self.win_bonus
        self.inv_reward = recip(max_reward)

    def reset_faults(self, s) -> list:
        """What in a reset state breaks the reset's rules: allies on the
        left quarter, enemies on the right quarter, full hp, cooldowns 0."""
        faults = []
        if not ((0 <= s["ally_r"]).all() and (s["ally_r"] < self.rows).all()
                and (0 <= s["ally_c"]).all() and (s["ally_c"] < self.cols // 4).all()):
            faults.append("ally spawn")
        if not ((0 <= s["enemy_r"]).all() and (s["enemy_r"] < self.rows).all()
                and (s["enemy_c"] >= 3 * self.cols // 4).all() and (s["enemy_c"] < self.cols).all()):
            faults.append("enemy spawn")
        if not ((s["ally_hp"] == self.a_maxhp).all() and (s["enemy_hp"] == self.e_maxhp).all()):
            faults.append("spawn hp")
        if s["ally_cd"].any() or s["enemy_cd"].any():
            faults.append("spawn cooldown")
        return faults

    def outputs(self, s):
        """(obs (N, D), mask (N, A)) of a state."""
        N, M = self.N, self.M
        alive, e_alive = s["ally_hp"] > 0, s["enemy_hp"] > 0
        rel_er = (s["enemy_r"][None, :] - s["ally_r"][:, None]).astype(f32)  # (N, M)
        rel_ec = (s["enemy_c"][None, :] - s["ally_c"][:, None]).astype(f32)
        dist_e = np.maximum(np.abs(rel_er), np.abs(rel_ec))
        in_range = e_alive[None, :] & (dist_e <= self.a_range[:, None])
        rel_ar = (s["ally_r"][None, :] - s["ally_r"][:, None]).astype(f32)  # (N, N')
        rel_ac = (s["ally_c"][None, :] - s["ally_c"][:, None]).astype(f32)
        dist_a = np.maximum(np.abs(rel_ar), np.abs(rel_ac))

        zero = f32(0)
        mask = np.zeros((N, self.n_actions), f32)
        mask[:, 0] = ~alive
        mask[:, 1] = alive
        moves = [s["ally_r"] - 1 >= 0, s["ally_r"] + 1 < self.rows, s["ally_c"] - 1 >= 0, s["ally_c"] + 1 < self.cols]
        for k, ok in enumerate(moves):
            mask[:, 2 + k] = ok & alive
        damaged = alive & (s["ally_hp"] < self.a_maxhp)
        heal_ok = damaged[None, :] & (dist_a <= self.a_range[:, None]) & ~np.eye(N, dtype=bool)  # (N, N')
        targets = np.zeros((N, self.n_targets), bool)
        targets[:, :M] = in_range
        targets[self.healer] = False
        targets[self.healer, :N] = heal_ok[self.healer]
        mask[:, 6:] = targets & alive[:, None]

        own = np.concatenate([(s["ally_hp"] * self.inv_a)[:, None], (s["ally_cd"] == 0)[:, None].astype(f32),
                              (s["ally_r"].astype(f32) * self.inv_r)[:, None],
                              (s["ally_c"].astype(f32) * self.inv_c)[:, None], self.a_hot], axis=1)
        vis_e = e_alive[None, :] & (dist_e <= self.sight)  # (N, M)
        enemy = np.concatenate([
            np.stack([vis_e.astype(f32), np.where(vis_e, rel_er * self.inv_r, zero),
                      np.where(vis_e, rel_ec * self.inv_c, zero),
                      np.where(vis_e, s["enemy_hp"][None, :] * self.inv_e[None, :], zero),
                      (vis_e & in_range).astype(f32)], axis=2),
            vis_e[:, :, None].astype(f32) * self.e_hot[None]], axis=2)  # (N, M, 5+tb)
        vis_a = alive[None, :] & (dist_a <= self.sight)  # (N, N')
        ally = np.concatenate([
            np.stack([vis_a.astype(f32), np.where(vis_a, rel_ar * self.inv_r, zero),
                      np.where(vis_a, rel_ac * self.inv_c, zero),
                      np.where(vis_a, s["ally_hp"][None, :] * self.inv_a[None, :], zero)], axis=2),
            vis_a[:, :, None].astype(f32) * self.a_hot[None]], axis=2)  # (N, N', 4+tb)
        others = ally[np.arange(N)[:, None], self.others]  # the other allies, in index order
        obs = np.concatenate([own, enemy.reshape(N, -1), others.reshape(N, -1)], axis=1).astype(f32)
        obs[~alive] = 0
        return obs, mask

    @property
    def obs_dim(self):
        tb = self.a_hot.shape[1]
        return (4 + tb) + self.M * (5 + tb) + (self.N - 1) * (4 + tb)

    def step(self, s, actions, mask):
        """(state, actions, the state's mask) -> (new state, team reward
        before any wrapper, terminated)."""
        N, M = self.N, self.M
        alive, e_alive = s["ally_hp"] > 0, s["enemy_hp"] > 0
        a = np.array([int(x) if mask[i, int(x)] > 0 else STOP for i, x in enumerate(actions)])
        move = (a >= 2) & (a <= 5) & alive
        dr = (a == 3).astype(int) - (a == 2).astype(int)
        dc = (a == 5).astype(int) - (a == 4).astype(int)
        ally_r = np.clip(s["ally_r"] + np.where(move, dr, 0), 0, self.rows - 1)
        ally_c = np.clip(s["ally_c"] + np.where(move, dc, 0), 0, self.cols - 1)

        targeting = (a >= 6) & alive & (s["ally_cd"] == 0)
        target = np.clip(a - 6, 0, max(M, N) - 1)
        dmg = np.zeros(M, f32)
        heal = np.zeros(N, f32)
        for i in range(N):
            if targeting[i] and not self.healer[i]:
                dmg[min(target[i], M - 1)] += self.a_dmg[i]
            elif targeting[i]:
                heal[min(target[i], N - 1)] += self.a_dmg[i]
        dmg = np.minimum(dmg, s["enemy_hp"])
        enemy_hp = np.maximum(s["enemy_hp"] - dmg, f32(0))
        kills = e_alive & (enemy_hp <= 0)
        ally_cd = np.where(targeting, self.a_cd, np.maximum(s["ally_cd"] - 1, 0))

        dist = np.maximum(np.abs(s["enemy_r"][:, None] - ally_r[None, :]), np.abs(s["enemy_c"][:, None] - ally_c[None, :]))
        dist = np.where(alive[None, :], dist, 10**6)
        nearest, nearest_dist = dist.argmin(1), dist.min(1)
        any_ally = alive.any()
        can_act = e_alive & (s["enemy_cd"] == 0) & any_ally
        shoot = can_act & ~self.e_healer & (nearest_dist <= self.e_range)
        dmg_ally = np.zeros(N, f32)
        for m in range(M):
            if shoot[m]:
                dmg_ally[nearest[m]] += self.e_dmg[m]
        alive_post = enemy_hp > 0
        e_dist = np.maximum(np.abs(s["enemy_r"][:, None] - s["enemy_r"][None, :]),
                            np.abs(s["enemy_c"][:, None] - s["enemy_c"][None, :]))
        deficit = np.where(alive_post, self.e_maxhp - enemy_hp, f32(-1))
        heal_enemy = np.zeros(M, f32)
        can_heal = np.zeros(M, bool)
        for m in range(M):
            ok = (deficit > 0) & (e_dist[m] <= self.e_range[m]) & (np.arange(M) != m)
            can_heal[m] = can_act[m] and self.e_healer[m] and ok.any()
            if can_heal[m]:
                heal_enemy[int(np.where(ok, deficit, f32(-1)).argmax())] += self.e_dmg[m]
        ally_hp = np.minimum(np.maximum(s["ally_hp"] - dmg_ally + heal, f32(0)), self.a_maxhp)
        ally_hp = np.where(alive, ally_hp, f32(0))
        enemy_hp = np.where(alive_post, np.minimum(np.maximum(enemy_hp + heal_enemy, f32(0)), self.e_maxhp), f32(0))
        acted = shoot | can_heal
        enemy_cd = np.where(acted, self.e_cd, np.maximum(s["enemy_cd"] - 1, 0))
        advance = e_alive & ~acted & any_ally
        enemy_r = np.clip(s["enemy_r"] + np.where(advance, np.sign(ally_r[nearest] - s["enemy_r"]), 0), 0, self.rows - 1)
        enemy_c = np.clip(s["enemy_c"] + np.where(advance, np.sign(ally_c[nearest] - s["enemy_c"]), 0), 0, self.cols - 1)

        win = not (enemy_hp > 0).any()
        reward = (dmg.sum(dtype=f32) + f32(self.kill_bonus) * f32(kills.sum()) + f32(self.win_bonus) * f32(win)) \
            * self.inv_reward
        t = s["t"] + 1
        terminated = win or not (ally_hp > 0).any() or t >= self.max_steps
        new = dict(ally_r=ally_r, ally_c=ally_c, ally_hp=ally_hp.astype(f32), ally_cd=ally_cd, enemy_r=enemy_r,
                   enemy_c=enemy_c, enemy_hp=enemy_hp.astype(f32), enemy_cd=enemy_cd, t=t)
        return new, f32(reward), terminated


def check_episodes(env: dict, obs, actions, rewards, dones, filled, masks, resets):
    """Replay padded episodes from their reset states through the rules and
    count the entries that differ (obs and rewards to 1e-6, the rest
    exactly). Episode-major: obs (K, T+1, N, D), actions (K, T, N), rewards
    (K, T, N), dones (K, T+1), filled (K, T), masks (K, T+1, N, A); resets:
    one state dict a row. Returns (mismatches, reset faults, first
    mismatch or None)."""
    sc = Scenario(env)
    K, T = np.asarray(filled).shape
    bad, faults, first = 0, 0, None
    for k in range(K):
        s = {key: np.asarray(v) for key, v in resets[k].items()}
        s["ally_hp"], s["enemy_hp"] = s["ally_hp"].astype(f32), s["enemy_hp"].astype(f32)
        s["t"] = 0
        faults += len(sc.reset_faults(s))
        o, m = sc.outputs(s)
        want = {"obs": [o], "masks": [m], "rewards": [], "dones": [0.0], "filled": []}
        running = True
        for t in range(T):
            want["filled"].append(1.0 if running else 0.0)
            if running:
                s, r, term = sc.step(s, actions[k, t], m)
                done = term or (t + 1) >= env["time_limit"]
                o, m = sc.outputs(s)
                want["obs"].append(o)
                want["masks"].append(m)
                want["rewards"].append(np.full(sc.N, r * f32(sc.N) if env.get("cooperative") else r, f32))
                want["dones"].append(1.0 if done else 0.0)
                running = not done
            else:
                want["obs"].append(np.zeros_like(o))
                want["masks"].append(np.ones_like(m))
                want["rewards"].append(np.zeros(sc.N, f32))
                want["dones"].append(0.0)
        checks = {
            "obs": (obs[k], np.stack(want["obs"]), 1e-6),
            "action masks": (masks[k], np.stack(want["masks"]), 0.0),
            "rewards": (rewards[k], np.stack(want["rewards"]), 1e-6),
            "dones": (dones[k], np.asarray(want["dones"]), 0.0),
            "filled": (filled[k], np.asarray(want["filled"]), 0.0),
            "padded actions": (actions[k] * (1 - np.asarray(filled[k])[:, None]), 0 * actions[k], 0.0),
            "actions out of range": ((actions[k] < 0) | (actions[k] >= sc.n_actions), 0 * actions[k], 0.0),
        }
        for name, (got, ref, tol) in checks.items():
            n = int(np.sum(np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)) > tol))
            if n and first is None:
                first = f"episode {k}: {name} differs in {n} entries"
            bad += n
    return bad, faults, first
