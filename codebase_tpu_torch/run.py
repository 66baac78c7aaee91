"""Train CLI — `python -m codebase_tpu_torch.run +algorithm=idqn env.name=... env.time_limit=25 [device=cpu]`.

The same override surface as the JAX package's `run.py`. Runs on the GPU
(`device: cuda` in `configs/default.yaml`) unless `device=cpu` is given;
`device=cuda` without a GPU raises. Run directories default to
`outputs/{env.name}/{algorithm.name}/{random tag}`. `algorithm.save_interval`
writes full-state checkpoints to `<run_dir>/checkpoints/`, `resume=<path>`
or `resume=auto` continues a run from one, and SIGTERM checkpoints and
exits cleanly; `python -m codebase_tpu_torch.eval path=<run_dir>`
evaluates a run from its checkpoint.

`distributed.devices=N` trains data-parallel over N ranks, one process per
GPU (`parallel/mesh.py`): the env batch and replay are sharded, params are
replicated and gradients summed, and only rank 0 writes files. The CLI
spawns the ranks itself (`distributed.devices=1` runs one rank in this
process, `all` one per visible GPU; `device=cpu` spawns CPU ranks over
gloo); under torchrun's variables `distributed.initialize` `auto` or
`always` joins that job's group instead.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
from pathlib import Path

from codebase_tpu_torch.algos.registry import get_algorithm
from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.envs.factory import make_env
from codebase_tpu_torch.parallel import mesh
from codebase_tpu_torch.utils import profiling
from codebase_tpu_torch.utils.device import resolve_device
from codebase_tpu_torch.utils.loggers import Logger, make_logger


# the keys of the `distributed` node, the JAX package's
DISTRIBUTED_KEYS = ("devices", "initialize")


def check_keys(cfg) -> None:
    """Raise ValueError on a `distributed` key the JAX package does not have."""
    dist = cfg.to_dict().get("distributed") or {}
    unknown = sorted(f"distributed.{k}" for k in dist if k not in DISTRIBUTED_KEYS) \
        if isinstance(dist, dict) else ["distributed"]
    if unknown:
        raise ValueError(f"unknown config keys {unknown}; `distributed` takes `devices` and `initialize`")


def build_envs(cfg):
    """The train env spec and the eval env spec (the same pure spec)."""
    env_cfg = cfg.env.to_dict()
    env_cfg.pop("parallel_envs", None)
    name = env_cfg.pop("name")
    env = make_env(name, **env_cfg)
    return env, env


def check_divides(cfg, world: int) -> None:
    """Raise ValueError unless the env batch (and a replay batch) divides
    over `world` ranks."""
    shard = mesh.Shard(world=world)
    shard.local(int(cfg.env.get("parallel_envs", cfg.algorithm.get("parallel_envs", 1))), "env.parallel_envs")
    if "batch_size" in cfg.algorithm:
        shard.local(int(cfg.algorithm.batch_size), "algorithm.batch_size")


def main(argv=None):
    """Train; returns (results.csv rows as dicts, final train state). A run
    that spawns its ranks returns rank 0's rows and no state."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    argv = list(argv if argv is not None else sys.argv[1:])
    cfg = load_config(argv)
    check_keys(cfg)
    if not cfg.env.get("name"):
        raise ValueError("env.name must be set")
    if not cfg.env.get("time_limit"):
        raise ValueError("Time limit must be set.")
    if "name" not in cfg.algorithm:
        raise ValueError("select an algorithm with +algorithm=<name>")
    if cfg.get("debug"):
        logging.getLogger("codebase_tpu_torch").warning(
            "debug=true: NaN, index and division checks on every op, anomaly mode in the backward and a NaN "
            "scan of each GRU kernel's outputs (utils/debug.py; expect several-fold slower iterations)"
        )
    device_name = cfg.get("device", "cuda")
    n_ranks = mesh.ranks_to_spawn(cfg.get("distributed"), device_name)
    if n_ranks:
        check_divides(cfg, n_ranks)
        return mesh.spawn(_rank_main, n_ranks, device_name, args=(argv,))[0], None
    shard = mesh.mesh_from_config(cfg.get("distributed"), device_name)
    try:
        if shard is not None:
            check_divides(cfg, shard.world)
        return _train(cfg, shard)
    finally:
        mesh.release(shard)


def _rank_main(argv):
    """One spawned rank: trains its share and returns its rows (rank 0's
    are the run's)."""
    return main(argv)[0]


def _train(cfg, shard):
    # full-f32 matmuls (allow_tf32 = False) are set here for the whole run,
    # on this rank's GPU
    device = resolve_device(cfg.get("device", "cuda"))
    algo = get_algorithm(cfg.algorithm.name, entry=cfg.algorithm.get("entry"))

    run_dir = cfg.get("run_dir")
    if not run_dir:
        tag = os.urandom(4).hex()
        run_dir = Path("outputs") / str(cfg.env.name).replace(":", "_") / cfg.algorithm.name / tag
    run_dir = Path(run_dir)
    if mesh.is_coordinator():
        run_dir.mkdir(parents=True, exist_ok=True)
        logger = make_logger(cfg, run_dir)
    else:
        # another rank writes nothing: results.csv, config.yaml, checkpoints
        # and videos are rank 0's
        logger = Logger(cfg.get("project_name", "codebase_tpu_torch"), cfg, run_dir)
    env, eval_env = build_envs(cfg)
    if cfg.get("seed") is None:
        logger.warning("No seed has been set.")
    if "parallel_envs" in cfg.env:
        cfg.algorithm.parallel_envs = int(cfg.env.parallel_envs)

    trace_dir = cfg.get("trace_dir")
    with profiling.trace(trace_dir) if trace_dir else contextlib.nullcontext():
        if trace_dir:
            logger.info(f"Capturing a profiler trace to {trace_dir}")
        state = algo(env, eval_env, logger, int(cfg.env.time_limit), cfg, device, shard)
    return logger.get_state(), state


if __name__ == "__main__":
    main()
