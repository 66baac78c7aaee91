"""The port on the card against the port on the CPU, on the same inputs.

    python -m codebase_tpu_torch.card_vs_cpu [--device cuda]

The CPU tests hold the port against the JAX package on the CPU; this module
holds the card against the CPU, so that the chain reaches the reference.
Every check raises AssertionError on a difference and returns a dict of its
numbers:

- `env_steps`: one reset state, made on the reference device, goes to both
  devices, and the same numpy actions (fixed seed) step both. The step's one
  draw, RWARE's requests after a delivery, is carried from the reference to
  the card after each step (the envs that did not deliver must already
  agree). Every state field, obs, reward, `terminated`, `truncated` and
  `action_mask` must be equal; float fields of an env that computes in
  floats (SMAClite) within `float_rtol`, with the count of entries that are
  not bitwise equal.
- `ia2c_updates`: the gate's IA2C config (`gate.GATES["ia2c_rware"]`) built
  on both devices, the same params (made on the reference, carried over as
  numpy), the same rollouts (numpy at RWARE's shapes and value ranges),
  consecutive updates: the metrics of every update and the params after the
  first and the last update within `UPDATE_TOL`.
- `idqn_rnn_updates`, `mappo_rnn_updates`: the same for the recurrent
  gates' configs (`idqn_rnn_lbf`, the main path, on LBF-shaped batches of
  32 episodes; `mappo_rnn_lbf` on LBF-shaped rollouts of 10 envs), within
  `RNN_UPDATE_TOL`: on the card every GRU runs through the hand-written
  kernels, on the CPU through their plain versions. Each reports the
  kernels' launches on the card.
- `draw_checks`: the card's own draws at fixed logits and masks against
  their distributions by a chi-square test at p >= `P_MIN`: `sample`
  (Gumbel-max, a masked action never drawn), `gumbel_argmax` (uniform over
  the allowed rows; `exponential_` never yields 0) and RWARE's
  `reset_batch` (spawn cells, directions and requests uniform).
- `delivery_rates`: RWARE's delivery counts under a uniform random policy
  (the first of 9 seeds, and their sum), and a trained checkpoint's mean
  return through the eval CLI, against the JAX package's vendored numbers
  (`docs/gate_evidence/port_h100/ia2c_rware/card_rates.json`) within 4
  standard deviations.

The CPU tests run each check cpu against cpu at a small size.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

from codebase_tpu_torch import gate
from codebase_tpu_torch.algos import dqn
from codebase_tpu_torch.algos.ac import METRICS, build_train_functions
from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.envs.api import gumbel_argmax
from codebase_tpu_torch.envs.factory import make_env
from codebase_tpu_torch.envs.rware import NOOP, RWARE
from codebase_tpu_torch.envs.vector import Rollout
from codebase_tpu_torch.models import distributions as D
from codebase_tpu_torch.ops import fused_gru
from codebase_tpu_torch.utils.device import resolve_device
from codebase_tpu_torch.utils.params import params_from_numpy, params_to_numpy, tree_leaves

CPU = torch.device("cpu")  # the reference device
RATES = gate.EVIDENCE / "port_h100" / "ia2c_rware" / "card_rates.json"
# name -> (envs, steps, time limit, float rtol): the phase's sizes
ENV_CASES = {
    "rware-tiny-2ag-v2": (2048, 500, 500, None),
    "lbforaging:Foraging-8x8-2p-3f-v3": (4096, 25, 25, None),
    "smaclite:3m-v0": (1024, 60, 60, 1e-6),
}
# RWARE's actions: FORWARD-heavy, with loads, so that shelves are picked
# up and put down (the CPU tests' distribution)
P_ACTIONS = [0.1, 0.4, 0.15, 0.15, 0.2]
# (rtol, atol) of the IA2C update, card against CPU: the first update, then
# every later one and the params after the last
UPDATE_TOL = {"first": (1e-5, 1e-6), "later": (1e-4, 1e-6)}
# (rtol, atol) of the recurrent updates (H=128), card against CPU. On the
# card the GRU runs through the hand-written kernels: 3xTF32 products (f32's
# ~2^-22 relative rounding of a product term), sums in another order, and
# `dW_hh` summed over T*B in partials; `chip_smoke.py` holds one call of
# each to 1e-5 (outputs, per-step gradients) and 1e-4 of the largest entry
# (`dW_hh`, `db_hh`). An update composes a 26-step recurrence forward and
# back through two networks (online and target, or actor, critic and target
# critic over 4 PPO epochs), so ten times those: 1e-4 on the first update;
# 20 Adam steps compound them, so 1e-3 after. An entry whose gradient
# cancels to its rounding could take Adam's first step (+-lr) the other way:
# that would fail here, and be reported with its leaf.
RNN_UPDATE_TOL = {"first": (1e-4, 1e-6), "later": (1e-3, 1e-5)}
P_MIN = 1e-4  # the chi-square tests' least p-value
SIGMAS = 4.0  # the delivery rates' band


# --- states on two devices


def _tensors(obj, prefix="") -> dict:
    """{field path: tensor} of a (wrapper-nested) env state or TimeStep."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    out = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if value is not None:
            out.update(_tensors(value, f"{prefix}.{f.name}" if prefix else f.name))
    return out


def _to(obj, device):
    """A copy of a (wrapper-nested) dataclass of tensors on `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return dataclasses.replace(obj, **{f.name: _to(getattr(obj, f.name), device)
                                       for f in dataclasses.fields(obj) if getattr(obj, f.name) is not None})


def _plant_deliveries(env: RWARE, s, envs) -> None:
    """In each env of `envs`, agent 0 stands on a goal cell carrying its
    env's first requested shelf; the other agents wait on the highway row
    above the goals, so that a NOOP step delivers (in place, on `s`, an
    `RWAREBatchState`)."""
    goal_r, goal_c = env.rows - 1, env.cols // 2 - 1
    for e in envs:
        shelf = int(torch.nonzero(s.requested[:, e])[0])
        s.agent_r[0, e], s.agent_c[0, e] = goal_r, goal_c
        s.agent_r[1:, e] = env.rows - 2
        s.agent_c[1:, e] = torch.arange(env.num_agents - 1, dtype=s.agent_c.dtype)
        s.carrying[0, e] = shelf
        s.shelf_carried[shelf, e] = True
        s.shelf_r[shelf, e], s.shelf_c[shelf, e] = goal_r, goal_c


class _Diff:
    """Compares one step's fields of two devices: exactly, or floats within
    `rtol` (counting the entries that are not bitwise equal). Raises on the
    first field that fails, naming the step and the field."""

    def __init__(self, name, rtol=None):
        self.name, self.rtol = name, rtol
        self.not_bitwise = 0
        self.first_not_bitwise = None
        self.max_rel = 0.0

    def __call__(self, step, field, got, ref, exact=False):
        got, ref = got.cpu(), ref.cpu()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{self.name}: step {step} {field}: {got.dtype}{tuple(got.shape)} against "
                                 f"{ref.dtype}{tuple(ref.shape)}")
        if torch.equal(got, ref):
            return
        where = torch.nonzero(got != ref)[0].tolist()
        if exact or self.rtol is None or not ref.is_floating_point():
            raise AssertionError(f"{self.name}: step {step} {field} differs first at {where}: "
                                 f"{got[tuple(where)].item()} against {ref[tuple(where)].item()}")
        err = (got - ref).abs()
        bad = err > self.rtol * ref.abs()
        if bad.any():
            at = torch.nonzero(bad)[0].tolist()
            raise AssertionError(f"{self.name}: step {step} {field} differs beyond rtol {self.rtol} first at {at}: "
                                 f"{got[tuple(at)].item()} against {ref[tuple(at)].item()}")
        self.not_bitwise += int((got != ref).sum())
        self.max_rel = max(self.max_rel, float((err / ref.abs().clamp(min=1e-30)).max()))
        if self.first_not_bitwise is None:
            self.first_not_bitwise = {"step": step, "field": field, "at": where}


def _actions(rng, mask, rware: bool, first: bool) -> np.ndarray:
    """(E, N) numpy actions: RWARE's P_ACTIONS (NOOP for the planted
    deliveries at the first step), else uniform over the valid actions of
    `mask` (E, N, A)."""
    E, N, A = mask.shape
    if rware:
        a = rng.choice(A, size=(E, N), p=P_ACTIONS)
        if first:
            a[::4, 0] = NOOP
        return a
    u = rng.random((E, N, A))
    return np.where(mask > 0, u, -1.0).argmax(-1)


def env_steps(name, n_envs, steps, time_limit, device, float_rtol=None, seed=0) -> dict:
    """`steps` steps of `n_envs` envs of `name` on `device` and on the CPU
    from one state and on the same actions; raises at the first field that
    differs. Returns the counts of the run."""
    dev, ref = torch.device(device), CPU
    env = make_env(name, time_limit=time_limit)
    base = env.base_env
    rware = isinstance(base, RWARE)
    state_ref, ts_ref = env.reset_batch(torch.Generator(ref).manual_seed(seed), n_envs)
    if rware:
        _plant_deliveries(base, env.inner_state(state_ref), range(0, n_envs, 4))
    state_dev = _to(state_ref, dev)
    gen_ref, gen_dev = (torch.Generator(d).manual_seed(seed + 1) for d in (ref, dev))
    diff = _Diff(name, float_rtol)
    rng = np.random.default_rng(seed)
    mask = ts_ref.action_mask.cpu().numpy()
    deliveries = pickups = done = 0
    for t in range(steps):
        a = torch.as_tensor(_actions(rng, mask, rware, t == 0))
        carried = env.inner_state(state_ref).shelf_carried.clone() if rware else None
        state_ref, ts_ref = env.step_batch(state_ref, a.to(ref), gen_ref)
        state_dev, ts_dev = env.step_batch(state_dev, a.to(dev), gen_dev)
        masks_ok = ("action_mask", "terminated", "truncated")
        for k in ("reward", "stat_reward", *masks_ok):
            diff(t, k, getattr(ts_dev, k), getattr(ts_ref, k), exact=k in masks_ok)
        if rware:
            # the requests drawn after a delivery: the reference's draw,
            # carried to the card; every env that did not deliver agrees
            delivered = (ts_ref.reward.sum(1) > 0).cpu()
            inner_ref, inner_dev = env.inner_state(state_ref), env.inner_state(state_dev)
            diff(t, "requested (no delivery)", inner_dev.requested.cpu()[:, ~delivered],
                 inner_ref.requested.cpu()[:, ~delivered])
            diff(t, "requested.sum(0)", inner_dev.requested.sum(0), inner_ref.requested.sum(0))
            diff(t, "obs (no delivery)", ts_dev.obs.cpu()[~delivered], ts_ref.obs.cpu()[~delivered])
            inner_dev.requested = inner_ref.requested.to(dev)
            diff(t, "obs", base._make_obs_batch(inner_dev), ts_ref.obs)
            deliveries += int(delivered.sum())
            pickups += int((inner_ref.shelf_carried & ~carried).sum())
        else:
            diff(t, "obs", ts_dev.obs, ts_ref.obs)
        for k, v in _tensors(state_ref).items():
            diff(t, f"state.{k}", _tensors(state_dev)[k], v)
        mask = ts_ref.action_mask.cpu().numpy()
        done += int(ts_ref.done.sum())
    out = {"env": name, "envs": n_envs, "steps": steps, "bitwise": diff.not_bitwise == 0, "episode_ends": done}
    if float_rtol is not None:
        out.update(float_rtol=float_rtol, float_entries_not_bitwise=diff.not_bitwise,
                   float_max_rel_diff=diff.max_rel, first_not_bitwise=diff.first_not_bitwise)
    if rware:
        out.update(deliveries=deliveries, pickups=pickups)
        if deliveries < n_envs // 4 or pickups == 0:
            raise AssertionError(f"{name}: {deliveries} deliveries and {pickups} pickups: the run did not deliver")
    return out


# --- the gate's IA2C update


def rware_rollout(rng, env: RWARE, T, E) -> dict:
    """A numpy rollout at RWARE's shapes and value ranges: obs (T+1, E, N,
    D) with the agent's row and column, then 0/1 features (one direction
    of the four); every episode runs T steps (RWARE ends only at its
    horizon); sparse 0/1 rewards; uniform actions."""
    N, Dm, A = env.n_agents, env.obs_dim, env.n_actions
    obs = (rng.random((T + 1, E, N, Dm)) < 0.2).astype(np.float32)
    obs[..., 0] = rng.integers(0, env.rows, size=(T + 1, E, N))
    obs[..., 1] = rng.integers(0, env.cols, size=(T + 1, E, N))
    obs[..., 3:7] = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=(T + 1, E, N))]
    dones = np.zeros((T + 1, E), np.float32)
    dones[T] = 1.0
    return dict(obs=obs, actions=rng.integers(0, A, size=(T, E, N)),
                rewards=(rng.random((T, E, N)) < 0.01).astype(np.float32), dones=dones,
                filled=np.ones((T, E), np.float32), action_mask=np.ones((T + 1, E, N, A), np.float32))


def _rollout_on(r, device) -> Rollout:
    t = {k: torch.as_tensor(v).to(device) for k, v in r.items()}
    return Rollout(obs=t["obs"], actions=t["actions"].long(), rewards=t["rewards"], stat_rewards=t["rewards"],
                   dones=t["dones"], filled=t["filled"], action_mask=t["action_mask"])


def _host(x):
    return x.detach().double().cpu()


def _rel(got, ref) -> float:
    return float(((_host(got) - _host(ref)).abs() / _host(ref).abs().clamp(min=1e-30)).max())


def _within(got, ref, tol) -> bool:
    rtol, atol = tol
    return bool(((_host(got) - _host(ref)).abs() <= atol + rtol * _host(ref).abs()).all())


def _check_updates(name, n_updates, tolerance, metric_names, step, param_leaves):
    """Run `step(u)` -> ({metric: device value}, {metric: reference value})
    for each update u and hold them, and the params (`param_leaves()` ->
    (device leaves, reference leaves)) after the first and the last update,
    to `tolerance` {"first": (rtol, atol), "later": (rtol, atol)}. Raises
    at the first difference, naming the update and what differs."""
    per_update, params_rel, params_abs = [], {}, {}
    for u in range(n_updates):
        m_dev, m_ref = step(u)
        tol = tolerance["first" if u == 0 else "later"]
        per_update.append({k: _rel(m_dev[k], m_ref[k]) for k in metric_names})
        bad = [k for k in metric_names if not _within(m_dev[k], m_ref[k], tol)]
        if bad:
            raise AssertionError(f"{name} update {u + 1}: {bad} differ beyond rtol {tol[0]} atol {tol[1]}: "
                                 f"{ {k: (float(m_dev[k]), float(m_ref[k])) for k in bad} }")
        if u in (0, n_updates - 1):
            got, want = param_leaves()
            params_rel[f"after_update_{u + 1}"] = max(_rel(g, w) for g, w in zip(got, want))
            params_abs[f"after_update_{u + 1}"] = max(float((_host(g) - _host(w)).abs().max())
                                                      for g, w in zip(got, want))
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if not _within(g, w, tol)]
            if bad:
                raise AssertionError(f"{name} params after update {u + 1}: leaves {bad} differ beyond rtol "
                                     f"{tol[0]} atol {tol[1]} (largest relative difference {params_rel}, "
                                     f"absolute {params_abs})")
    return {"updates": n_updates, "tolerance": tolerance, "max_rel_by_update": per_update,
            "max_rel": {k: max(m[k] for m in per_update) for k in metric_names}, "params_max_rel": params_rel,
            "params_max_abs": params_abs}


def _gru_launches(before) -> dict:
    """The GRU kernels' launches since `before` (`launch_counts()`), nonzero only."""
    now = fused_gru.launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def _gate_config(name, envs=None):
    g = gate.GATES[name]
    cfg = load_config([f"+algorithm={g.algo}", *g.overrides])
    acfg = cfg.algorithm
    acfg.parallel_envs = int(envs if envs is not None else cfg.env.parallel_envs)
    return cfg, acfg, make_env(cfg.env.name, time_limit=int(cfg.env.time_limit))


def ac_updates(name, make_rollout, device, n_updates=20, T=None, envs=None, seed=0, tolerance=UPDATE_TOL) -> dict:
    """`n_updates` consecutive updates of gate `name`'s actor-critic config
    (its preset and overrides; `envs` envs, default the gate's) on `device`
    and on the CPU from the same params on the same rollouts of T steps
    (default the gate's time limit), `make_rollout(rng, env, T, E)` each a
    dict of numpy arrays. Raises unless each update's metrics, and the
    params after the first and the last update, agree within `tolerance`.
    Returns the largest relative difference of each metric at each update,
    the largest relative and absolute differences of the params, and the
    GRU kernels' launches on the device."""
    dev, ref = resolve_device(device), resolve_device(CPU)  # f32 matmuls (allow_tf32 off)
    cfg, acfg, env = _gate_config(name, envs)
    E, T = acfg.parallel_envs, int(T if T is not None else cfg.env.time_limit)
    (init_ref, _, _, update_ref), (init_dev, _, _, update_dev) = (
        build_train_functions(env, env, acfg, T, d) for d in (ref, dev))
    state_ref, state_dev = init_ref(seed), init_dev(seed)
    # the same init: made once on the reference, carried over as numpy
    state_dev.model.load_params(params_to_numpy(state_ref.model.param_tree()))
    state_dev.target_critic.load_params(params_from_numpy(params_to_numpy(state_ref.target_critic.param_tree()), dev))
    rng = np.random.default_rng(seed)
    before = fused_gru.launch_counts()

    def step(u):
        r = make_rollout(rng, env, T, E)
        m_ref = update_ref(state_ref, _rollout_on(r, ref))
        m_dev = update_dev(state_dev, _rollout_on(r, dev))
        for state in (state_ref, state_dev):
            state.env_steps += T * E
        return m_dev, m_ref

    def leaves():
        got, want = (tree_leaves(s.model.param_tree()) + tree_leaves(s.target_critic.param_tree())
                     for s in (state_dev, state_ref))
        return got, want

    out = _check_updates(name, n_updates, tolerance, METRICS, step, leaves)
    return {"config": name, "envs": E, "T": T, "n_steps": int(acfg.n_steps), **out,
            "gru_launches": _gru_launches(before)}


def ia2c_updates(device, n_updates=20, T=None, seed=0) -> dict:
    """`ac_updates` of the ia2c_rware gate's config (10 envs, MLPs) on
    RWARE-shaped rollouts, within `UPDATE_TOL`."""
    return ac_updates("ia2c_rware", lambda rng, env, T, E: rware_rollout(rng, env.base_env, T, E), device,
                      n_updates, T, seed=seed)


def lbf_rollout(rng, env, T, E) -> dict:
    """A numpy rollout at LBF's shapes and value ranges (the triples
    observation of `lbforaging.py`): per food and then per agent (row, col,
    level), an eaten food (-1, -1, 0); episodes of T steps or ended early
    (all food eaten, half of them), steps after the end unfilled; sparse
    rewards of a food's share; uniform actions; no action mask."""
    base = env.base_env
    N, Dm, A = env.n_agents, env.obs_dim, env.n_actions
    cells = rng.integers(0, min(base.rows, base.cols), size=(T + 1, E, Dm // 3, 2)).astype(np.float32)
    levels = rng.integers(1, 4, size=(T + 1, E, Dm // 3, 1)).astype(np.float32)
    triples = np.concatenate([cells, levels], -1)
    eaten = (rng.random((T + 1, E, base.max_food)) < 0.3)
    triples[:, :, :base.max_food][eaten] = (-1.0, -1.0, 0.0)
    obs = np.broadcast_to(triples.reshape(T + 1, E, 1, Dm), (T + 1, E, N, Dm)).copy()
    lengths = np.where(rng.random(E) < 0.5, T, rng.integers(5, T + 1, size=E))
    filled = (np.arange(T)[:, None] < lengths[None]).astype(np.float32)
    dones = np.zeros((T + 1, E), np.float32)
    dones[lengths, np.arange(E)] = 1.0
    rewards = np.where(rng.random((T, E, N)) < 0.03, rng.uniform(0.1, 0.5, size=(T, E, N)), 0.0)
    return dict(obs=obs, actions=rng.integers(0, A, size=(T, E, N)),
                rewards=(rewards * filled[..., None]).astype(np.float32), dones=dones, filled=filled,
                action_mask=np.ones((T + 1, E, N, A), np.float32))


def mappo_rnn_updates(device, n_updates=20, T=None, envs=None, seed=0) -> dict:
    """`ac_updates` of the mappo_rnn_lbf gate's config (recurrent actor and
    centralised recurrent critic, H=128, 4 PPO epochs) on LBF-shaped
    rollouts, within `RNN_UPDATE_TOL`: on the card every GRU of the update
    and of the target critic runs through the hand-written kernels."""
    return ac_updates("mappo_rnn_lbf", lbf_rollout, device, n_updates, T, envs, seed, RNN_UPDATE_TOL)


def _dqn_batch(r, device) -> dict:
    """A numpy rollout (`lbf_rollout`) as the DQN update's reference-layout
    batch: obss (N, T+1, B, D), actions and rewards (N, T, B), dones (T+1,
    B), filled (T, B); no action mask (LBF has none)."""
    t = {k: torch.as_tensor(v).to(device) for k, v in r.items()}
    return dict(obss=t["obs"].permute(2, 0, 1, 3).contiguous(), actions=t["actions"].permute(2, 0, 1).long(),
                rewards=t["rewards"].permute(2, 0, 1).contiguous(), dones=t["dones"], filled=t["filled"],
                action_mask=None)


def idqn_rnn_updates(device, n_updates=20, batch_size=None, seed=0) -> dict:
    """`n_updates` consecutive IDQN updates of the idqn_rnn_lbf gate's
    config (the main path: Linear -> ReLU -> GRU(128) -> Linear an agent,
    double Q, Adam, a hard target every 200 updates) on `device` and on the
    CPU from the same params (online and target) on the same LBF-shaped
    batches of `batch_size` episodes (default the preset's 32), within
    `RNN_UPDATE_TOL`. Returns what `ac_updates` returns, for the loss."""
    dev, ref = resolve_device(device), resolve_device(CPU)
    cfg, acfg, env = _gate_config("idqn_rnn_lbf")
    T, B = int(cfg.env.time_limit), int(batch_size if batch_size is not None else acfg.batch_size)
    (init_ref, it_ref, _), (init_dev, it_dev, _) = (
        dqn.build_train_functions(env, env, acfg, T, d) for d in (ref, dev))
    state_ref, state_dev = init_ref(seed), init_dev(seed)
    state_dev.model.load_params(params_to_numpy(state_ref.model.param_tree()))
    state_dev.target.load_params(params_to_numpy(state_ref.target.param_tree()))
    rng = np.random.default_rng(seed)
    before = fused_gru.launch_counts()

    def step(u):
        r = lbf_rollout(rng, env, T, B)
        loss_ref = it_ref.update(state_ref, _dqn_batch(r, ref))
        loss_dev = it_dev.update(state_dev, _dqn_batch(r, dev))
        return {"loss": loss_dev}, {"loss": loss_ref}

    def leaves():
        got, want = (tree_leaves(s.model.param_tree()) + tree_leaves(s.target.param_tree())
                     for s in (state_dev, state_ref))
        return got, want

    out = _check_updates("idqn_rnn_lbf", n_updates, RNN_UPDATE_TOL, ("loss",), step, leaves)
    return {"config": "idqn_rnn_lbf", "batch_size": B, "T": T, **out, "gru_launches": _gru_launches(before)}


# --- the card's draws against their distributions


def chi2_p(counts, probs) -> float:
    """The chi-square test's p-value of `counts` against `probs` (the
    categories of positive probability)."""
    counts, probs = np.asarray(counts, np.float64), np.asarray(probs, np.float64)
    expected = counts.sum() * probs
    stat = float(((counts - expected) ** 2 / expected).sum())
    dof = len(counts) - 1
    return float(torch.special.gammaincc(torch.tensor(dof / 2, dtype=torch.float64),
                                         torch.tensor(stat / 2, dtype=torch.float64)))


def _test(name, counts, probs) -> dict:
    p = chi2_p(counts, probs)
    if not p >= P_MIN:
        raise AssertionError(f"{name}: chi-square p {p:.3e} < {P_MIN} (counts {list(counts)})")
    return {"n": int(np.sum(counts)), "chi2_p": p}


def draw_checks(device, n=2**22, reset_envs=2**16, seed=0) -> dict:
    """The device's draws against their distributions: `sample` over 5
    actions with one masked, `gumbel_argmax` over rware-tiny-2ag's shelves
    with 2 excluded (and the zeros of `exponential_` on a draw of that
    shape), and the marginals of `RWARE.reset_batch`."""
    dev = torch.device(device)
    out = {}
    # Gumbel-max sampling: frequencies are the masked softmax
    logits = torch.tensor([0.3, -0.7, 1.1, 0.0, 0.5], device=dev)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0, 1.0], device=dev)
    g = torch.Generator(dev).manual_seed(seed)
    a = D.sample(g, D.apply_mask(logits, mask).expand(n, 5))
    counts = torch.bincount(a, minlength=5).cpu().numpy()
    if counts[3]:
        raise AssertionError(f"sample: the masked action was drawn {counts[3]} times")
    allowed = mask.cpu().numpy() > 0
    probs = torch.softmax(logits.cpu().double()[allowed], 0).numpy()
    out["sample"] = {**_test("sample", counts[allowed], probs), "counts": counts.tolist()}
    # uniform choice among the allowed shelves
    env = make_env("rware-tiny-2ag-v2", time_limit=500).base_env
    S = env.n_shelves
    excluded = [5, 17]
    rows = torch.ones((S, 1), dtype=torch.bool, device=dev)
    rows[excluded] = False
    choice = gumbel_argmax(rows.expand(S, n), g)
    counts = torch.bincount(choice, minlength=S).cpu().numpy()
    if counts[excluded].any():
        raise AssertionError(f"gumbel_argmax: an excluded shelf was drawn {counts[excluded].tolist()} times")
    keep = np.ones(S, bool)
    keep[excluded] = False
    e = torch.empty((S, n), device=dev).exponential_(generator=g)
    zeros, infs = int((e == 0).sum()), int(torch.isinf(e).sum())
    del e
    if zeros or infs:
        raise AssertionError(f"exponential_: {zeros} zeros and {infs} infinities in {S * n} draws")
    out["gumbel_argmax"] = {**_test("gumbel_argmax", counts[keep], np.full(S - 2, 1 / (S - 2))), "shelves": S,
                            "excluded": excluded, "exponential_draws": S * n, "exponential_zeros": zeros}
    # the reset: spawn cells, directions and requests
    state, _ = env.reset_batch(torch.Generator(dev).manual_seed(seed + 1), reset_envs)
    cells = (state.agent_r * env.cols + state.agent_c).long()
    if not bool((cells[0] != cells[1]).all()) or not bool((state.requested.sum(0) == env.request_queue_size).all()):
        raise AssertionError("reset_batch: agents share a cell or a request queue is not full")
    R = env.rows * env.cols
    reset = {}
    for i in range(env.num_agents):
        reset[f"agent{i}_cell"] = _test(f"reset agent {i} cell", torch.bincount(cells[i], minlength=R).cpu().numpy(),
                                        np.full(R, 1 / R))
        reset[f"agent{i}_dir"] = _test(f"reset agent {i} direction",
                                       torch.bincount(state.agent_dir[i].long(), minlength=4).cpu().numpy(),
                                       np.full(4, 0.25))
    reset["requested"] = _test("reset requests", state.requested.sum(1).cpu().numpy(), np.full(S, 1 / S))
    out["reset_batch"] = {"envs": reset_envs, **reset}
    return out


# --- delivery rates against the JAX package's


def random_policy_deliveries(device, n_envs=2048, T=500, seed=1) -> float:
    """Deliveries of `n_envs` whole episodes of rware-tiny-2ag-v2 under a
    uniform random policy, the port's own draws on `device` (the protocol
    of the JAX counts in `card_rates.json`)."""
    dev = torch.device(device)
    env = make_env("rware-tiny-2ag-v2", time_limit=T)
    g = torch.Generator(dev).manual_seed(seed)
    state, _ = env.reset_batch(g, n_envs)
    total = torch.zeros((), device=dev)
    for _ in range(T):
        actions = torch.randint(0, env.n_actions, (n_envs, env.n_agents), generator=g, device=dev)
        state, ts = env.step_batch(state, actions, g)
        total += ts.reward.sum()
    return float(total)


def eval_deliveries(device, run_dir, episodes, seed=0) -> dict:
    """The eval CLI (`codebase_tpu_torch.eval`) on a run dir: the mean,
    std and sum of the episodes' returns (summed over agents)."""
    from codebase_tpu_torch import eval as port_eval

    returns = port_eval.main([f"path={run_dir}", f"eval_episodes={episodes}", f"seed={seed}",
                              f"device={device}"]).sum(-1)
    return {"episodes": int(returns.shape[0]), "mean": float(returns.mean()), "std": float(returns.std()),
            "deliveries": float(returns.sum())}


def _poisson_check(name, port, jax) -> dict:
    """Two delivery counts: |port - JAX| within 4 sd of their Poisson
    difference, sqrt(port + JAX)."""
    sd = math.sqrt(port + jax)
    if abs(port - jax) > SIGMAS * sd:
        raise AssertionError(f"{name}: {port} deliveries against the JAX package's {jax}: beyond {SIGMAS} sd "
                             f"({sd:.2f})")
    return {"port_deliveries": port, "jax_deliveries": jax, "sd": sd, "z": (port - jax) / sd}


def delivery_rates(device, rates_path=RATES) -> dict:
    """The device's random-policy counts and the vendored checkpoint's eval
    against the JAX package's numbers: |port - JAX| within 4 standard
    deviations, of the Poisson difference of the counts (the first seed
    against the first JAX key, and the sums over all of them), and of the
    difference of the mean returns (from each side's episodes)."""
    rates = json.loads(Path(rates_path).read_text())
    rp = rates["random_policy"]
    counts = [random_policy_deliveries(device, rp["envs"], rp["steps"], s) for s in rp["port_seeds"]]
    out = {"random_policy": {"envs": rp["envs"], "steps": rp["steps"], "port_seeds": rp["port_seeds"],
                             "jax_keys": rp["jax_keys"], "port_by_seed": counts,
                             "first": _poisson_check("random policy, first seed", counts[0], rp["jax_deliveries"][0]),
                             "sum": _poisson_check("random policy, summed", sum(counts), sum(rp["jax_deliveries"]))}}
    ce = rates["checkpoint_eval"]
    port = eval_deliveries(device, gate.REPO / ce["run_dir"], ce["episodes"], ce["seed"])
    jax = ce["jax"]
    se = math.sqrt(port["std"] ** 2 / port["episodes"] + jax["std"] ** 2 / jax["episodes"])
    z = (port["mean"] - jax["mean"]) / se if se > 0 else 0.0
    out["checkpoint_eval"] = {"run_dir": ce["run_dir"], "checkpoint": ce["checkpoint"], "port": port, "jax": jax,
                              "se": se, "z": z}
    if abs(port["mean"] - jax["mean"]) > SIGMAS * se:
        raise AssertionError(f"checkpoint eval: mean return {port['mean']} on {device} against the JAX "
                             f"package's {jax['mean']}: beyond {SIGMAS} se ({se:.4g})")
    return out


def run_all(device) -> dict:
    """Every check, `device` against the CPU. Returns their numbers."""
    return {"envs": [env_steps(name, E, steps, T, device, rtol) for name, (E, steps, T, rtol) in ENV_CASES.items()],
            "ia2c_update": ia2c_updates(device), "idqn_rnn_update": idqn_rnn_updates(device),
            "mappo_rnn_update": mappo_rnn_updates(device), "draws": draw_checks(device),
            "delivery_rates": delivery_rates(device)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m codebase_tpu_torch.card_vs_cpu",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="the device held against the CPU")
    args = parser.parse_args(argv)
    resolve_device(args.device)  # cuda without a GPU raises
    print(json.dumps(run_all(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
