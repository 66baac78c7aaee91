"""SMAC-style cooperative micromanagement combat with action masks, batched
on one device, env axis last.

The same rules as the JAX package's `envs/smaclite.py`:
- actions: 0 = no-op (only valid when dead), 1 = stop, 2..5 = move N/S/W/E,
  6+j = attack enemy j, except medivacs, whose target slots heal ally j;
  `n_actions = 6 + max targets`; an action the mask forbids becomes STOP;
- masks: each agent's valid actions, `TimeStep.action_mask`;
- reward: damage dealt (no overkill credit) + kill bonus per kill + win
  bonus, over `max_reward`, the same for every agent;
- termination: one side eliminated or `max_steps`;
- observations: own features, then per-enemy and per-other-ally blocks,
  with unit-type one-hots when the scenario mixes types;
- scripted enemies: fighters shoot the nearest living ally in range (the
  first one on ties) or step towards it; enemy medivacs heal their
  most-damaged teammate in range by post-damage hp (a unit killed this step
  stays dead).

Only the batched path is ported: every state field is `(N, E)`, `(M, E)` or
`(E,)`. The step and the observations are compare-and-select over those
tensors and match the JAX package exactly on the same state and actions.
Division by a constant (hp by max hp, coordinates by the map size, the
reward by `max_reward`) is a multiplication by the constant's float32
reciprocal, as XLA compiles the JAX package's division: a true division
differs from it in the last bit, and a multiplication rounds the same way
on the CPU and on the card. Spawns draw from a `torch.Generator`: the same
distribution as the JAX package's draws, not the same numbers.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Tuple

import torch

from codebase_tpu_torch.envs.api import Environment, TimeStep

NOOP, STOP, MOVE_N, MOVE_S, MOVE_W, MOVE_E = range(6)

# unit stats: (max_hp incl shields, damage-or-heal per shot, attack range
# [Chebyshev cells], cooldown steps, is_healer), the JAX package's table
UNIT_STATS = {
    "marine": (45.0, 6.0, 4, 1, False),
    "stalker": (160.0, 13.0, 5, 1, False),
    "zealot": (150.0, 16.0, 1, 1, False),
    "marauder": (125.0, 10.0, 5, 1, False),
    "medivac": (150.0, 9.0, 4, 1, True),
}
_UNIT_ORDER = tuple(UNIT_STATS)
_DEAD_DIST = 10**6  # distance of a dead ally to every enemy


@dataclass
class CombatBatchState:
    """E env instances in struct-of-arrays, env-axis-last layout."""

    ally_r: torch.Tensor  # (N, E) int32
    ally_c: torch.Tensor  # (N, E) int32
    ally_hp: torch.Tensor  # (N, E) float32
    ally_cd: torch.Tensor  # (N, E) int32 cooldown counters
    enemy_r: torch.Tensor  # (M, E) int32
    enemy_c: torch.Tensor  # (M, E) int32
    enemy_hp: torch.Tensor  # (M, E) float32
    enemy_cd: torch.Tensor  # (M, E) int32
    t: torch.Tensor  # (E,) int32


@dataclass(frozen=True)
class SmacLiteCombat(Environment):
    n_allies: int = 5
    n_enemies: int = 5
    # unit type names per slot; empty = all marines
    ally_types: Tuple[str, ...] = ()
    enemy_types: Tuple[str, ...] = ()
    rows: int = 16
    cols: int = 16
    sight_range: int = 6
    max_steps: int = 100
    kill_bonus: float = 10.0
    win_bonus: float = 200.0
    # optional uniform overrides of the per-type stats (None = the table)
    max_hp: float = None  # type: ignore[assignment]
    damage: float = None  # type: ignore[assignment]
    attack_range: int = None  # type: ignore[assignment]
    cooldown: int = None  # type: ignore[assignment]

    # ------------------------------------------------------------- type stats

    @property
    def a_types(self) -> Tuple[str, ...]:
        return self.ally_types or ("marine",) * self.n_allies

    @property
    def e_types(self) -> Tuple[str, ...]:
        return self.enemy_types or ("marine",) * self.n_enemies

    def _stats(self, types, idx) -> list:
        override = (self.max_hp, self.damage, self.attack_range, self.cooldown, None)[idx]
        if override is not None:
            return [override] * len(types)
        return [UNIT_STATS[t][idx] for t in types]

    @functools.lru_cache(maxsize=16)
    def _consts(self, device: torch.device) -> SimpleNamespace:
        """The per-unit stat columns ((N, 1) or (M, 1)), the type one-hots
        and the scalar divisors as tensors on `device`, made once: a Python
        list copied to the card at every step would hold the host up."""

        def column(types, idx, dtype):
            return torch.tensor(self._stats(types, idx), dtype=dtype, device=device)[:, None]

        def reciprocal(values):  # float32 1/x, correctly rounded on the host
            return (1.0 / torch.tensor(values, dtype=torch.float32)).to(device)

        f32, i32, b = torch.float32, torch.int32, torch.bool
        a, e = self.a_types, self.e_types
        return SimpleNamespace(
            a_maxhp=column(a, 0, f32), a_dmg=column(a, 1, f32), a_range=column(a, 2, i32),
            a_cds=column(a, 3, i32), healer=column(a, 4, b),
            e_maxhp=column(e, 0, f32), e_dmg=column(e, 1, f32), e_range=column(e, 2, i32),
            e_cds=column(e, 3, i32), e_healer=column(e, 4, b),
            inv_a_maxhp=reciprocal(self._stats(a, 0))[:, None],
            inv_e_maxhp=reciprocal(self._stats(e, 0))[:, None],
            inv_rows=reciprocal(float(self.rows)),
            inv_cols=reciprocal(float(self.cols)),
            inv_max_reward=reciprocal(self.max_reward),
            a_onehot=self._type_onehot(a, device), e_onehot=self._type_onehot(e, device),
            zero=torch.zeros((), device=device),
        )

    @property
    def n_agents(self) -> int:
        return len(self.a_types)

    @property
    def _n_e(self) -> int:
        return len(self.e_types)

    @property
    def _has_medivac(self) -> bool:
        return any(UNIT_STATS[t][4] for t in self.a_types + self.e_types)

    @property
    def n_actions(self) -> int:
        # medivac target slots index allies; uniform action space = 6 + max
        n_targets = self._n_e
        if self._has_medivac:
            n_targets = max(n_targets, self.n_agents, len(self.e_types))
        return 6 + n_targets

    @property
    def has_action_mask(self) -> bool:
        return True

    @property
    def _type_table(self) -> Tuple[str, ...]:
        return tuple(sorted(set(self.a_types + self.e_types), key=_UNIT_ORDER.index))

    @property
    def type_bits(self) -> int:
        """SMAC unit_type_bits: one-hot width, 0 for homogeneous scenarios."""
        n = len(self._type_table)
        return n if n > 1 else 0

    def _type_onehot(self, types, device) -> torch.Tensor:
        """(len(types), type_bits) one-hot rows (no columns when homogeneous)."""
        out = torch.zeros((len(types), self.type_bits), device=device)
        if self.type_bits:
            table = self._type_table
            for i, t in enumerate(types):
                out[i, table.index(t)] = 1.0
        return out

    @property
    def obs_dim(self) -> int:
        tb = self.type_bits
        # own: hp, cd_ready, y, x [+type]; enemy: visible, rel_y, rel_x, hp,
        # in_range [+type]; other ally: visible, rel_y, rel_x, hp [+type]
        return (4 + tb) + self._n_e * (5 + tb) + (self.n_agents - 1) * (4 + tb)

    @property
    def max_reward(self) -> float:
        return float(sum(self._stats(self.e_types, 0))) + len(self.e_types) * self.kill_bonus + self.win_bonus

    # ------------------------------------------------------------------ reset

    def reset_batch(self, generator: torch.Generator, n: int):
        """Allies spawn uniformly on the left quarter of the map, enemies on
        the right quarter, at full hp and ready to act."""
        N, M = self.n_agents, self._n_e
        dev = generator.device
        i32 = torch.int32

        def draw(lo, hi, units):
            return torch.randint(lo, hi, (units, n), generator=generator, device=dev, dtype=i32)

        k = self._consts(dev)
        state = CombatBatchState(
            ally_r=draw(0, self.rows, N),
            ally_c=draw(0, self.cols // 4, N),
            ally_hp=k.a_maxhp.expand(N, n).contiguous(),
            ally_cd=torch.zeros((N, n), dtype=i32, device=dev),
            enemy_r=draw(0, self.rows, M),
            enemy_c=draw(3 * self.cols // 4, self.cols, M),
            enemy_hp=k.e_maxhp.expand(M, n).contiguous(),
            enemy_cd=torch.zeros((M, n), dtype=i32, device=dev),
            t=torch.zeros((n,), dtype=i32, device=dev),
        )
        obs, mask = self._outputs_batch(state)
        zeros = torch.zeros((n, N), device=dev)
        ts = TimeStep(
            obs=obs,
            reward=zeros,
            stat_reward=zeros,
            terminated=torch.zeros((n,), dtype=torch.bool, device=dev),
            truncated=torch.zeros((n,), dtype=torch.bool, device=dev),
            action_mask=mask,
        )
        return state, ts

    # ------------------------------------------------------ obs and mask

    def _outputs_batch(self, state: CombatBatchState):
        """(obs (E, N, D), mask (E, N, A)) in one pass: the observation's
        in-range feature and the mask's attack availability share the
        viewer -> target geometry."""
        N, M = self.n_agents, self._n_e
        E = state.ally_r.shape[1]
        dev = state.ally_r.device
        f32 = torch.float32
        k = self._consts(dev)
        inv_r, inv_c, zero = k.inv_rows, k.inv_cols, k.zero
        a_range, healer, a_maxhp = k.a_range, k.healer, k.a_maxhp
        a_onehot, e_onehot = k.a_onehot, k.e_onehot  # (N, tb), (M, tb)
        tb = self.type_bits
        alive = state.ally_hp > 0  # (N, E)
        e_alive = state.enemy_hp > 0  # (M, E)

        # enemies: viewer axis N, target axis M
        rel_er = (state.enemy_r[None] - state.ally_r[:, None, :]).to(f32)
        rel_ec = (state.enemy_c[None] - state.ally_c[:, None, :]).to(f32)
        dist_e = torch.maximum(rel_er.abs(), rel_ec.abs())  # (N, M, E)
        in_attack_range = e_alive[None] & (dist_e <= a_range[:, None, :])
        # allies: viewer axis N, target axis N'
        rel_ar = (state.ally_r[None] - state.ally_r[:, None, :]).to(f32)
        rel_ac = (state.ally_c[None] - state.ally_c[:, None, :]).to(f32)
        dist_a = torch.maximum(rel_ar.abs(), rel_ac.abs())  # (N, N, E)

        # ------------------------------------------------------------ mask
        move_ok = torch.stack(
            [state.ally_r - 1 >= 0, state.ally_r + 1 < self.rows, state.ally_c - 1 >= 0, state.ally_c + 1 < self.cols],
            dim=1,
        )  # (N, 4, E): N, S, W, E
        n_targets = self.n_actions - 6
        pad = torch.zeros((N, n_targets - M, E), dtype=torch.bool, device=dev)
        attack_ok = torch.cat([in_attack_range, pad], dim=1)
        if self._has_medivac:
            damaged = alive & (state.ally_hp < a_maxhp)  # (N, E)
            not_self = ~torch.eye(N, dtype=torch.bool, device=dev)[:, :, None]
            heal_ok = damaged[None] & (dist_a <= a_range[:, None, :]) & not_self
            heal_pad = torch.zeros((N, n_targets - N, E), dtype=torch.bool, device=dev)
            heal_ok = torch.cat([heal_ok, heal_pad], dim=1)
            attack_ok = torch.where(healer[:, None, :], heal_ok, attack_ok)
        mask = torch.cat(
            [(~alive)[:, None, :], alive[:, None, :], move_ok & alive[:, None, :], attack_ok & alive[:, None, :]],
            dim=1,
        ).to(f32)  # (N, A, E)

        # ------------------------------------------------------------- obs
        own = [
            state.ally_hp * k.inv_a_maxhp,
            (state.ally_cd == 0).to(f32),
            state.ally_r.to(f32) * inv_r,
            state.ally_c.to(f32) * inv_c,
        ]
        own += [a_onehot[:, j, None].expand(N, E) for j in range(tb)]
        own = torch.stack(own, dim=1)  # (N, 4+tb, E)

        vis_e = e_alive[None] & (dist_e <= self.sight_range)
        vis_ef = vis_e.to(f32)
        ecols = [
            vis_ef,
            torch.where(vis_e, rel_er * inv_r, zero),
            torch.where(vis_e, rel_ec * inv_c, zero),
            torch.where(vis_e, state.enemy_hp[None] * k.inv_e_maxhp[None], zero),
            (vis_e & in_attack_range).to(f32),
        ]
        ecols += [vis_ef * e_onehot[None, :, j, None] for j in range(tb)]
        enemy_feats = torch.stack(ecols, dim=2)  # (N, M, 5+tb, E)

        vis_a = alive[None] & (dist_a <= self.sight_range)
        vis_af = vis_a.to(f32)
        acols = [
            vis_af,
            torch.where(vis_a, rel_ar * inv_r, zero),
            torch.where(vis_a, rel_ac * inv_c, zero),
            torch.where(vis_a, state.ally_hp[None] * k.inv_a_maxhp.reshape(1, N, 1), zero),
        ]
        acols += [vis_af * a_onehot[None, :, j, None] for j in range(tb)]
        ally_feats = torch.stack(acols, dim=2)  # (N, N', 4+tb, E)
        # per viewer i: the other allies in index order, self skipped
        others = torch.stack([torch.cat([ally_feats[i, :i], ally_feats[i, i + 1 :]], dim=0) for i in range(N)])

        obs = torch.cat(
            [own, enemy_feats.reshape(N, -1, E), others.reshape(N, -1, E)], dim=1
        )  # (N, D, E)
        obs = torch.where(alive[:, None, :], obs, zero)  # a dead agent sees zeros
        return obs.permute(2, 0, 1).contiguous(), mask.permute(2, 0, 1).contiguous()

    # ------------------------------------------------------------------- step

    def step_batch(self, state: CombatBatchState, actions, generator=None, current_mask=None):
        """Batched transition, deterministic given the actions.
        `current_mask` (E, N, A), when the caller holds the mask of `state`,
        saves recomputing it for the validity check; the result is the same."""
        del generator
        N, M = self.n_agents, self._n_e
        a = actions.T.to(torch.int32)  # (N, E)
        E = a.shape[1]
        dev = a.device
        f32, i32 = torch.float32, torch.int32
        k = self._consts(dev)
        alive = state.ally_hp > 0
        e_alive = state.enemy_hp > 0
        midx = torch.arange(M, dtype=i32, device=dev)[None, :, None]  # target axis of (N, M, E)
        nidx = torch.arange(N, dtype=i32, device=dev)[None, :, None]  # target axis of (N, N, E)
        zero = k.zero

        # invalid actions become STOP
        if current_mask is None:
            current_mask = self._outputs_batch(state)[1]
        mask = current_mask.permute(1, 2, 0)  # (N, A, E)
        aidx = torch.arange(mask.shape[1], dtype=i32, device=dev)[None, :, None]
        valid = (mask * (aidx == a[:, None, :])).sum(1) > 0
        a = torch.where(valid, a, STOP)

        # --- ally movement
        is_move = (a >= MOVE_N) & (a <= MOVE_E) & alive
        dr = (a == MOVE_S).to(i32) - (a == MOVE_N).to(i32)
        dc = (a == MOVE_E).to(i32) - (a == MOVE_W).to(i32)
        ally_r = (state.ally_r + torch.where(is_move, dr, 0)).clamp(0, self.rows - 1)
        ally_c = (state.ally_c + torch.where(is_move, dc, 0)).clamp(0, self.cols - 1)

        # --- ally attacks and heals
        targeting = (a >= 6) & alive & (state.ally_cd == 0)
        attacking = targeting & ~k.healer
        healing = targeting & k.healer
        target_id = (a - 6).clamp(0, max(M, N) - 1)  # (N, E)
        hits = attacking[:, None, :] & (target_id.clamp(0, M - 1)[:, None, :] == midx)  # (N, M, E)
        dmg_to_enemy = (hits * k.a_dmg[:, None, :]).sum(0)  # (M, E)
        dmg_to_enemy = torch.minimum(dmg_to_enemy, state.enemy_hp)  # no overkill credit
        enemy_hp = torch.clamp(state.enemy_hp - dmg_to_enemy, min=0.0)
        kills = e_alive & (enemy_hp <= 0)
        heals = healing[:, None, :] & (target_id.clamp(0, N - 1)[:, None, :] == nidx)  # (N, N, E)
        heal_to_ally = (heals * k.a_dmg[:, None, :]).sum(0)  # (N, E)
        ally_cd = torch.where(targeting, k.a_cds, (state.ally_cd - 1).clamp(min=0))

        # --- scripted enemies: shoot the nearest living ally in range, else
        # advance towards it; enemy medivacs heal
        dist = torch.maximum(
            (state.enemy_r[:, None, :] - ally_r[None]).abs(), (state.enemy_c[:, None, :] - ally_c[None]).abs()
        )  # (M, N, E)
        dist = torch.where(alive[None], dist, _DEAD_DIST)
        nearest = dist.argmin(1)  # (M, E), the first on ties
        nearest_dist = dist.amin(1)
        any_ally = alive.any(0)  # (E,)
        can_act = e_alive & (state.enemy_cd == 0) & any_ally[None, :]
        can_shoot = can_act & ~k.e_healer & (nearest_dist <= k.e_range)
        near_onehot = nearest[:, None, :] == torch.arange(N, device=dev)[None, :, None]  # (M, N, E)
        dmg_to_ally = ((can_shoot[:, None, :] & near_onehot) * k.e_dmg[:, None, :]).sum(0)  # (N, E)

        # enemy healers: most-damaged teammate by POST-damage hp; a unit
        # killed this step stays dead
        e_alive_post = enemy_hp > 0  # (M, E)
        e_dist = torch.maximum(
            (state.enemy_r[:, None, :] - state.enemy_r[None]).abs(),
            (state.enemy_c[:, None, :] - state.enemy_c[None]).abs(),
        )  # (M, M, E)
        deficit = torch.where(e_alive_post, k.e_maxhp - enemy_hp, -1.0)  # (M, E)
        not_self_e = ~torch.eye(M, dtype=torch.bool, device=dev)[:, :, None]
        healable = (deficit[None] > 0) & (e_dist <= k.e_range[:, None, :]) & not_self_e
        heal_target = torch.where(healable, deficit[None], -1.0).argmax(1)  # (M, E), the first on ties
        can_heal = can_act & k.e_healer & healable.any(1)
        mmidx = torch.arange(M, device=dev)[None, :, None]
        heal_to_enemy = ((can_heal[:, None, :] & (heal_target[:, None, :] == mmidx)) * k.e_dmg[:, None, :]).sum(0)

        ally_hp = torch.minimum(torch.clamp(state.ally_hp - dmg_to_ally + heal_to_ally, min=0.0), k.a_maxhp)
        ally_hp = torch.where(alive, ally_hp, zero)  # heals cannot resurrect
        enemy_hp = torch.minimum(torch.clamp(enemy_hp + heal_to_enemy, min=0.0), k.e_maxhp)
        enemy_hp = torch.where(e_alive_post, enemy_hp, zero)
        acted = can_shoot | can_heal
        enemy_cd = torch.where(acted, k.e_cds, (state.enemy_cd - 1).clamp(min=0))

        # enemies that did not act step towards their nearest ally
        tgt_r = (near_onehot * ally_r[None]).sum(1)  # (M, E)
        tgt_c = (near_onehot * ally_c[None]).sum(1)
        advance = e_alive & ~acted & any_ally[None, :]
        enemy_r = (state.enemy_r + torch.where(advance, torch.sign(tgt_r - state.enemy_r), 0)).clamp(0, self.rows - 1)
        enemy_c = (state.enemy_c + torch.where(advance, torch.sign(tgt_c - state.enemy_c), 0)).clamp(0, self.cols - 1)

        # --- the shaped team reward
        win = ~(enemy_hp > 0).any(0)  # (E,)
        shaped = (
            dmg_to_enemy.sum(0) + self.kill_bonus * kills.sum(0).to(f32) + self.win_bonus * win.to(f32)
        ) * k.inv_max_reward
        reward = shaped[:, None].expand(E, N).contiguous()

        t = state.t + 1
        lose = ~(ally_hp > 0).any(0)
        terminated = win | lose | (t >= self.max_steps)

        new_state = CombatBatchState(
            ally_r=ally_r.to(i32),
            ally_c=ally_c.to(i32),
            ally_hp=ally_hp,
            ally_cd=ally_cd.to(i32),
            enemy_r=enemy_r.to(i32),
            enemy_c=enemy_c.to(i32),
            enemy_hp=enemy_hp,
            enemy_cd=enemy_cd.to(i32),
            t=t,
        )
        obs, next_mask = self._outputs_batch(new_state)
        ts = TimeStep(
            obs=obs,
            reward=reward,
            stat_reward=reward,
            terminated=terminated,
            truncated=torch.zeros((E,), dtype=torch.bool, device=dev),
            action_mask=next_mask,
        )
        return new_state, ts


_UNIT_LETTERS = {"m": "marine", "s": "stalker", "z": "zealot", "r": "marauder", "d": "medivac"}


def _parse_side(spec: str) -> Tuple[str, ...]:
    """'3s5z' -> 3 stalkers + 5 zealots; the MMM family is the caller's."""
    units = []
    count = ""
    for ch in spec:
        if ch.isdigit():
            count += ch
        else:
            if ch not in _UNIT_LETTERS:
                raise ValueError(f"unknown unit letter {ch!r} in {spec!r}")
            units.extend([_UNIT_LETTERS[ch]] * int(count or 1))
            count = ""
    if count:
        raise ValueError(f"trailing count in {spec!r}")
    return tuple(units)


def parse_smaclite_name(name: str) -> SmacLiteCombat:
    """Scenario ids: `{N}m[_vs_{M}m]`, `2s3z`, `3s5z`, `3s5z_vs_3s6z`, `MMM`,
    `MMM2`, or any `<count><unit>` combo (units m/s/z/r/d), optionally
    `smaclite:`-prefixed and `-v0`-suffixed."""
    base = name.split(":")[-1].split("-")[0]
    if base == "MMM":
        allies = enemies = ("medivac",) + ("marauder",) * 2 + ("marine",) * 7
    elif base == "MMM2":
        allies = ("medivac",) + ("marauder",) * 2 + ("marine",) * 7
        enemies = ("medivac",) + ("marauder",) * 3 + ("marine",) * 8
    else:
        parts = base.split("_vs_")
        allies = _parse_side(parts[0])
        enemies = _parse_side(parts[1]) if len(parts) > 1 else allies
    return SmacLiteCombat(n_allies=len(allies), n_enemies=len(enemies), ally_types=allies, enemy_types=enemies)
