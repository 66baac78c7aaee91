"""Train CLI — `python -m codebase_tpu_torch.run +algorithm=idqn env.name=... env.time_limit=25 [device=cpu]`.

The same override surface as the JAX package's `run.py`. Runs on the GPU
(`device: cuda` in `configs/default.yaml`) unless `device=cpu` is given;
`device=cuda` without a GPU raises. Run directories default to
`outputs/{env.name}/{algorithm.name}/{random tag}`.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path

from codebase_tpu_torch.algos.registry import get_algorithm
from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.envs.factory import make_env
from codebase_tpu_torch.utils.device import resolve_device
from codebase_tpu_torch.utils.loggers import make_logger


# JAX-package keys the port does not do yet, each with its default (absent
# or null counts as the default) and the ROADMAP.md item that ports it: a run
# that sets one is refused before anything is built
NOT_PORTED = {
    "resume": (None, "Queue 1 item 4, checkpoint and resume"),
    "trace_dir": (None, "Queue 1 item 7, tooling (a torch.profiler trace)"),
    "debug": (False, "Queue 1 item 7, tooling (NaN and anomaly checks)"),
    "distributed.devices": (None, "Queue 1 item 6, multi-GPU"),
    "distributed.initialize": ("auto", "Queue 1 item 6, multi-GPU"),
    "algorithm.entry": (None, "Queue 1 item 7, tooling (algorithm.entry and register_algorithm)"),
}


def _lookup(data: dict, key: str):
    for part in key.split("."):
        data = data.get(part) if isinstance(data, dict) else None
    return data


def refuse_unported(cfg) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item of each, on any
    `NOT_PORTED` key set off its default; ValueError on a `distributed` key
    the JAX package does not have."""
    data = cfg.to_dict()
    dist = data.get("distributed") or {}
    unknown = sorted(f"distributed.{k}" for k in dist if f"distributed.{k}" not in NOT_PORTED) \
        if isinstance(dist, dict) else ["distributed"]
    if unknown:
        raise ValueError(f"unknown config keys {unknown}; `distributed` takes `devices` and `initialize`")
    found = [f"{k} is not ported yet (ROADMAP.md {item})"
             for k, (default, item) in NOT_PORTED.items() if (_lookup(data, k) or default) != default]
    if found:
        raise NotImplementedError("; ".join(found))


def build_envs(cfg):
    """The train env spec and the eval env spec (the same pure spec)."""
    env_cfg = cfg.env.to_dict()
    env_cfg.pop("parallel_envs", None)
    name = env_cfg.pop("name")
    env = make_env(name, **env_cfg)
    return env, env


def main(argv=None):
    """Train; returns (results.csv rows as dicts, final train state)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    cfg = load_config(argv if argv is not None else sys.argv[1:])
    refuse_unported(cfg)
    if not cfg.env.get("name"):
        raise ValueError("env.name must be set")
    if not cfg.env.get("time_limit"):
        raise ValueError("Time limit must be set.")
    if "name" not in cfg.algorithm:
        raise ValueError("select an algorithm with +algorithm=<name>")
    # full-f32 matmuls (allow_tf32 = False) are set here for the whole run
    device = resolve_device(cfg.get("device", "cuda"))
    algo = get_algorithm(cfg.algorithm.name)

    run_dir = cfg.get("run_dir")
    if not run_dir:
        tag = os.urandom(4).hex()
        run_dir = Path("outputs") / str(cfg.env.name).replace(":", "_") / cfg.algorithm.name / tag
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    logger = make_logger(cfg, run_dir)
    env, eval_env = build_envs(cfg)
    if cfg.get("seed") is None:
        logger.warning("No seed has been set.")
    if "parallel_envs" in cfg.env:
        cfg.algorithm.parallel_envs = int(cfg.env.parallel_envs)

    state = algo(env, eval_env, logger, int(cfg.env.time_limit), cfg, device)
    return logger.get_state(), state


if __name__ == "__main__":
    main()
