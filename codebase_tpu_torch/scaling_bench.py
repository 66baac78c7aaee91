"""Data-parallel scaling: env-steps/s per world size, the port's counterpart
of the JAX package's `scripts/scaling_bench.py`.

    python -m codebase_tpu_torch.scaling_bench [--worlds 1,2] [--envs-per-rank 32768]
        [--iters 3] [--rnn] [--device cuda|cpu]

Trains the IDQN LBF lane (`lbforaging:Foraging-8x8-2p-3f-v3`, T=25, batch
256, 8 updates a collect, a replay of 4 episodes an env, as the JAX
script) over W ranks of `parallel/mesh.py` for each W, with
`--envs-per-rank` envs a rank (weak scaling), and prints one JSON line per
W: env-steps/s of the timed iterations (host clock around work that ends
in a device sync), the per-iteration seconds, and the seconds a timed
iteration spends in each kind of collective and in the random draws
(a second pass with each bracketed by device syncs), beside the card's
name and power limit.

With at least W GPUs the ranks take one GPU each over NCCL. With fewer
(one H100), W=1 runs NCCL and W > 1 puts the ranks on GPU 0 over gloo:
they share one card, so those lines are not scaling numbers, and say so
(`"shared_gpu": true`). `--device cpu` runs gloo ranks on the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from codebase_tpu_torch.parallel import mesh

LANE = ["+algorithm=idqn", "env.name=lbforaging:Foraging-8x8-2p-3f-v3", "env.time_limit=25",
        "algorithm.updates_per_collect=8", "algorithm.training_start=0", "algorithm.replay_slot_reuse=clear"]


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    GPU 0, or "cpu"."""
    if not torch.cuda.is_available():
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def lane_argv(world: int, envs_per_rank: int, rnn: bool, device: str) -> list:
    E = envs_per_rank * world
    return LANE + [f"env.parallel_envs={E}", "algorithm.batch_size=256",
                   f"algorithm.buffer_size={4 * E}", f"algorithm.model.use_rnn={str(rnn).lower()}",
                   f"device={device}", "seed=0"]


def _rank(argv, iters: int, warmup: int) -> dict:
    """One rank: warm-up iterations, `iters` timed ones, then `iters` more
    with the collectives and draws timed."""
    from codebase_tpu_torch.algos.dqn import build_train_functions
    from codebase_tpu_torch.config import load_config
    from codebase_tpu_torch.run import build_envs
    from codebase_tpu_torch.utils.device import resolve_device, sync

    cfg = load_config(argv)
    device = resolve_device(cfg.device)
    env, eval_env = build_envs(cfg)
    cfg.algorithm.parallel_envs = int(cfg.env.parallel_envs)
    shard = mesh.world()
    init_state, train_iteration, _ = build_train_functions(env, eval_env, cfg.algorithm, int(cfg.env.time_limit),
                                                           device, shard=shard)
    state = init_state(0)

    def run(n):
        steps0 = state.env_steps
        sync(device)
        t0 = time.perf_counter()
        seconds = []
        for _ in range(n):
            t = time.perf_counter()
            float(train_iteration(state)["loss"])
            seconds.append(time.perf_counter() - t)
        return state.env_steps - steps0, time.perf_counter() - t0, seconds

    run(warmup)
    steps, total, seconds = run(iters)
    shard.times = {}  # the timed pass: each collective and draw between device syncs
    run(iters)
    times = {k: {"ms_per_iter": s / iters * 1e3, "calls_per_iter": n / iters} for k, (s, n) in shard.times.items()}
    return {"env_steps": steps, "seconds": total, "iteration_seconds": seconds, "times": times}


def measure(world: int, envs_per_rank: int, iters: int, warmup: int, rnn: bool, device: str) -> dict:
    argv = lane_argv(world, envs_per_rank, rnn, device)
    shared = device == "cuda" and torch.cuda.device_count() < world
    kwargs = {}
    if shared:
        kwargs = dict(backend="gloo", device_ids=[0] * world)
    ranks = mesh.spawn(_rank, world, device, args=(argv, iters, warmup), **kwargs)
    r0 = ranks[0]
    return {
        "world": world, "device": device,
        "backend": "gloo" if device == "cpu" or shared else "nccl",
        "shared_gpu": shared,
        "note": ("ranks share one GPU: not a scaling number" if shared else
                 "one rank" if world == 1 else f"{world} ranks, one GPU each" if device == "cuda" else "CPU ranks"),
        "card": card(), "envs": envs_per_rank * world, "rnn": rnn,
        "env_steps_per_s": r0["env_steps"] / r0["seconds"],
        "iteration_seconds": r0["iteration_seconds"],
        "per_rank_timed_pass": [r["times"] for r in ranks],
    }


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--worlds", default="1,2", help="comma-separated world sizes")
    p.add_argument("--envs-per-rank", type=int, default=32768)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--rnn", action="store_true", help="the recurrent critic (the GRU kernels)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was requested but no CUDA GPU is visible")
    lines = []
    worlds = [int(w) for w in args.worlds.split(",")]
    for world in worlds:
        line = measure(world, args.envs_per_rank, args.iters, args.warmup, args.rnn, args.device)
        # weak scaling against the first world size, where the ranks do not
        # share a device
        base = lines[0] if lines else line
        line["efficiency_vs_linear"] = None if line["shared_gpu"] else (
            line["env_steps_per_s"] / (base["env_steps_per_s"] * world / worlds[0]))
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
