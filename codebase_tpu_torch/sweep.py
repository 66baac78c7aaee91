"""Multi-seed, multi-hyperparameter training: the units of a sweep trained
together, the port's counterpart of the JAX package's `codebase_tpu/sweep.py`.

A unit is one (hyperparameter variant, seed) pair. The JAX package vmaps
its jitted train chunk over the units; here the units of a group form one
train state (`build_train_functions(..., hypers=...)` of `algos/dqn.py` and
`algos/ac.py`): their envs, replay slots and networks are stacked, the
networks fold the units into their agent axis, so every layer, and every
GRU kernel launch, serves all units of the group at once:

- the seed axis always folds;
- learning rate, gamma and the target-update tau (within the config's
  hard or Polyak regime) fold too (`VMAPPABLE_KEYS`): each unit keeps its
  own value;
- hyperparameters that change shapes or static structure (batch size,
  architecture, parallel_envs) stay a loop over groups (`search.py`).

The loop is the JAX sweep's: chunks of `min(max(1, eval_interval //
(E*T)), 256)` iterations while the slowest unit's env steps are at most
`total_steps`; a row for every unit when the slowest unit is
`eval_interval` steps past the last row: the DQN family's eval episodes
(`eval_episodes` a unit, the eval generator seeded `max(seeds) + 1`), the
actor-critic family's last training rollout, with `updates`,
`environment_steps` and the chunk's nan-mean `loss`. Each unit writes its
own `config.yaml` and `results.csv` under `run_dir[/<variant>]/seed_<s>/`,
so the analysis tools read it as an ordinary run. A sweep does not
checkpoint, as the JAX one does not.

`distributed.devices=N` shards a group's units over N ranks, as the JAX
sweep shards its vmapped unit axis over the mesh: rank r trains units
`[r*U/N, (r+1)*U/N)` as one train state and writes their directories (U
must divide over N: ValueError naming "divide"). Each unit's rows are what
the unsharded group writes: the ranks seed the group's generator with the
whole group's first seed and draw at the whole group's shape
(`parallel/mesh.py`, mode unit), and agree on the host decisions (the
slowest unit's steps, the early exit, "any unit can update").
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import yaml

from codebase_tpu_torch.algos.common import unit_values
from codebase_tpu_torch.config import Config
from codebase_tpu_torch.parallel import mesh
from codebase_tpu_torch.run import build_envs, check_keys
from codebase_tpu_torch.utils.device import resolve_device, sync
from codebase_tpu_torch.utils.loggers import append_results_row, episode_infos, squash_info

log = logging.getLogger("codebase_tpu_torch")

DQN_FAMILY = ("idqn", "vdn", "qmix")

# config dot-paths whose scalar values fold into the unit axis
VMAPPABLE_KEYS = {
    "algorithm.lr": "lr",
    "algorithm.gamma": "gamma",
    "algorithm.target_update_interval_or_tau": "tau",
}


def _variant_label(variant: Dict[str, float]) -> str:
    return ",".join(f"{k}={v:g}" for k, v in sorted(variant.items()))


def group_units(seeds: Sequence[int], hyper_variants=None) -> list:
    """The (variant index, seed) units of a group, variant-major,
    seed-minor, as the JAX sweep orders them."""
    return [(vi, int(s)) for vi in range(len(hyper_variants or [{}])) for s in seeds]


def build_group(cfg, seeds: Sequence[int], hyper_variants: Optional[List[Dict[str, float]]] = None, shard=None):
    """The train functions and initial state of one group: (units, state,
    train_iteration, evaluate), the units (variant index, seed)
    variant-major, seed-minor, as the JAX sweep orders them. With a `shard`
    (mode unit) only this rank's units. `debug` checks the group's
    iterations (`utils/debug.py`); `algorithm.entry` and `trace_dir`, which
    a group does not run, raise ValueError (the `single` and `locally` modes
    run each unit through `run.py`, which takes them)."""
    check_keys(cfg)
    for key in ("algorithm.entry", "trace_dir"):
        node, _, leaf = key.rpartition(".")
        if (cfg.get(node) if node else cfg).get(leaf):
            raise ValueError(f"{key} is not taken by a vmapped group; run the units with the single or locally "
                             "mode (each a codebase_tpu_torch.run)")
    device = resolve_device(cfg.get("device", "cuda"))
    env, eval_env = build_envs(cfg)
    time_limit = int(cfg.env.time_limit)
    if "parallel_envs" in cfg.env:
        cfg.algorithm.parallel_envs = int(cfg.env.parallel_envs)
    variants = hyper_variants or [{}]
    units = group_units(seeds, hyper_variants)
    first_seed = units[0][1]  # the group's generator seed, whatever the rank
    if shard is not None:
        n = shard.local(len(units), "the number of (variant x seed) units")
        units = units[shard.rank * n:(shard.rank + 1) * n]
    if cfg.algorithm.name in DQN_FAMILY:
        from codebase_tpu_torch.algos.dqn import build_train_functions
    else:
        from codebase_tpu_torch.algos.ac import build_train_functions
    init_state, train_iteration, evaluate = build_train_functions(
        env, eval_env, cfg.algorithm, time_limit, device, hypers=[variants[vi] for vi, _ in units], shard=shard,
        debug=bool(cfg.get("debug")),
    )[:3]
    state = init_state([s for _, s in units], generator_seed=first_seed)
    return units, state, train_iteration, evaluate


def unit_dir(run_dir: Path, variants, unit) -> Path:
    """`run_dir[/<variant>]/seed_<s>` of a (variant index, seed) unit."""
    vi, s = unit
    d = Path(run_dir)
    if variants != [{}]:
        d = d / _variant_label(variants[vi])
    return d / f"seed_{s}"


def run_vmapped_multiseed(
    cfg,
    seeds: Sequence[int],
    run_dir: Path,
    hyper_variants: Optional[List[Dict[str, float]]] = None,
):
    """Train one configuration's (hyper-variant x seed) units together.

    `hyper_variants` is a list of {"lr"/"gamma"/"tau": value} dicts; None
    trains just the seed axis. Writes one reference-compatible
    `results.csv` + `config.yaml` per unit (under
    `run_dir[/variant]/seed_<s>/`). Returns the unit run dirs.

    `distributed.devices` shards the units over ranks (spawned here unless
    this process is a rank already); each rank writes its units' files.
    """
    run_dir = Path(run_dir)
    variants = hyper_variants or [{}]
    device_name = cfg.get("device", "cuda")
    n_ranks = mesh.ranks_to_spawn(cfg.get("distributed"), device_name)
    if n_ranks:
        mesh.Shard(world=n_ranks).local(len(group_units(seeds, hyper_variants)),
                                        "the number of (variant x seed) units")
        mesh.spawn(_rank_sweep, n_ranks, device_name, args=(cfg.to_dict(), list(seeds), run_dir, hyper_variants))
        return [unit_dir(run_dir, variants, u) for u in group_units(seeds, hyper_variants)]
    shard = mesh.mesh_from_config(cfg.get("distributed"), device_name, mode="unit")
    try:
        return _train_group(cfg, seeds, run_dir, hyper_variants, shard)
    finally:
        mesh.release(shard)


def _rank_sweep(cfg_dict, seeds, run_dir, hyper_variants):
    """One spawned rank of a sharded group."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    run_vmapped_multiseed(Config(cfg_dict), seeds, run_dir, hyper_variants)


def _train_group(cfg, seeds, run_dir, hyper_variants, shard):
    variants = hyper_variants or [{}]
    units, state, train_iteration, evaluate = build_group(cfg, seeds, hyper_variants, shard)
    U = len(units)
    device = state.generator.device
    world = shard or mesh.Shard()

    is_dqn = cfg.algorithm.name in DQN_FAMILY
    acfg = cfg.algorithm
    time_limit = int(cfg.env.time_limit)
    total_steps = int(acfg.total_steps)
    eval_interval = int(acfg.eval_interval) if acfg.eval_interval else 10_000
    n_envs = int(acfg.get("parallel_envs", 1))
    chunk_iters = min(max(1, eval_interval // (n_envs * time_limit)), 256)

    # per-unit writers
    unit_dirs = []
    for vi, s in units:
        d = unit_dir(run_dir, variants, (vi, s))
        d.mkdir(parents=True, exist_ok=True)
        unit_cfg = cfg.to_dict()
        unit_cfg["seed"] = int(s)
        for path, short in VMAPPABLE_KEYS.items():
            if short in variants[vi]:
                node, leaf = path.split(".")
                unit_cfg[node][leaf] = float(variants[vi][short])
        (d / "config.yaml").write_text(yaml.safe_dump(unit_cfg, sort_keys=False))
        (d / "results.csv").write_text("")
        unit_dirs.append(d)
    columns = [None] * U

    eval_gen = torch.Generator(device=device).manual_seed(max(seeds) + 1)
    last_eval = np.zeros(U, np.int64)
    step = 0
    while step < total_steps + 1:
        losses = []
        for _ in range(chunk_iters):
            before = unit_values(state.env_steps, U)
            sync(device)
            t0 = time.perf_counter()
            metrics = train_iteration(state)
            losses.append(metrics["loss"].reshape(U).cpu().numpy())  # waits for the iteration
            state.timings.append((int((unit_values(state.env_steps, U) - before).sum()), time.perf_counter() - t0))
        env_steps = unit_values(state.env_steps, U)
        # the slowest unit of the whole group, and its steps since a row
        mins = torch.tensor([env_steps.min(), (env_steps - last_eval).min()], dtype=torch.int64, device=world.device)
        step, since_row = world.all_reduce(mins, dist.ReduceOp.MIN, "steps").tolist()

        if since_row >= eval_interval:
            out = evaluate(state, eval_gen) if is_dqn else metrics
            returns = out["episode_returns"].reshape((U, -1) + out["episode_returns"].shape[1:])  # (U, E, N)
            lengths = out["episode_lengths"].reshape(U, -1)
            chunk_losses = np.asarray(losses, np.float64)  # (iters, U)
            updates = unit_values(state.updates, U)
            for ui, d in enumerate(unit_dirs):
                infos = episode_infos({"episode_returns": returns[ui], "episode_lengths": lengths[ui]})
                extra = {"updates": int(updates[ui]), "environment_steps": int(env_steps[ui])}
                if np.any(~np.isnan(chunk_losses[:, ui])):
                    extra["loss"] = float(np.nanmean(chunk_losses[:, ui]))
                infos.append(extra)
                columns[ui] = append_results_row(d / "results.csv", squash_info(infos), columns[ui])
            last_eval = env_steps.copy()
            log.info(
                "sweep %s: %d units, steps ~%d, mean return %.4f",
                run_dir.name,
                U,
                step,
                float(returns.sum(-1).mean()),
            )
    return unit_dirs
