"""Profiling CLI — where one training iteration's time goes, on the GPU.

    python -m codebase_tpu_torch.profile +algorithm=idqn|vdn|qmix|ia2c|maa2c|ippo|mappo \
        env.name=... env.time_limit=25 \
        [profile.warmup=1 profile.iters=3 | profile.chunks=4 profile.chunk_iters=8]
        [profile.top=15] [profile.trace_dir=<dir>] [distributed.devices=N] [any run override]

Builds the train iteration for the config, runs `warmup` iterations, times
`iters` iterations on the host clock as one span that ends in a device sync
(`utils/profiling.time_windows`), runs `iters` more with the host-span
collector open (`utils/profiling.host_spans`, no profiler) and the
counters reset before them, then `iters` more under `torch.profiler`. A
value-based iteration ends in the host loop's read of its loss
(`algos/dqn_train.read_loss`, the host sync `sync/loss`), as in training. The JAX package's keys take the place of the port's:
`chunks` x `chunk_iters` iterations timed after a warmup of one chunk of
`chunk_iters`, and one chunk traced. A run that mixes the two sets, or
passes any other `profile.*` key, raises ValueError. It prints one JSON
line: the algorithm and env, the card and its power limit, env-steps/s,
updates/s and iteration time untraced, the device time of
every kernel (kernels, copies and fills, each counted once) per iteration,
split over the iteration's named ranges (the value-based family's
`dqn/rollout`, `dqn/reward_stream` when the env stack standardises rewards,
`dqn/replay_add` and `dqn/updates`; the actor-critic family's `ac/rollout`,
`ac/reward_stream` and `ac/update`) and the sub-ranges, every other span of
`utils/profiling.SPANS`: `env/step` (the env steps inside the rollout, the
rest of it being the policy), `dqn/sample` (the replay gather),
`dqn/optimizer` (the clip and Adam), `gru/forward` and `gru/backward` (the
GRU recurrence, in the rollout and the updates), `linear/dw` (the f32
weight gradients of the backward, `ops/grouped_dw.py`), `qmix/mixer` (the
QMIX mixer's forward, online and target) and the host syncs `sync/*`; the
device's busy share, the GRU kernels' launches and time, the kernels with
the most device time, and the peak device memory. From the
host-span pass: `host_spans` (per span name and iteration: calls, host ms,
self ms less its child spans, and ms inside `sync/*` spans; a CUDA
backward's spans are roots on the autograd engine's thread),
`host_span_iteration_ms`, and the counters per iteration:
`policy_steps_per_iter` (the rollout's steps run),
`env_steps_by_path_per_iter` (the env steps' `graph_captures`,
`graph_replays` and `eager` steps, `envs/step_graph.py`), `syncs_per_iter` (by
name), `gru_calls_per_iter` (the recurrence's calls by direction and shape),
`gru_launches_per_iter`, `linear_dw_calls_per_iter` (the f32 weight
gradients by route, "kernel" or "cublas", and shape (G, K, M, N)),
`linear_mm_calls_per_iter` (the f32 Linear's forward and input-gradient
products by direction, route and shape (G, R, K, N)),
`linear_launches_per_iter` (the weight gradient and product kernels'
launches) and
`mixer_calls_per_iter` (the QMIX mixer's calls by shape (U, K, S): units,
rows, state width).

The busy share is kernel time over the untraced iteration time: tracing
slows the host's launch loop (`traced_iteration_ms`, and less so
`host_span_iteration_ms`) but not the kernels.
Device numbers need `device=cuda`; on the CPU they read null.

`iteration_flops` counts the operations of as many iterations as the
traced pass runs, an iteration's share (`utils/profiling.count_operations`:
PyTorch's ops, plus the GRU kernels' from their shapes), the counterpart of
the JAX report's `chunk_flops`; `tflops_per_s` is that over the untraced
iteration time.
The count runs in a pass of its own before the traced one: it slows the
host loop, and its dispatch modes keep the env step eager, where the other
passes replay the step's CUDA graph on the card.
`profile.trace_dir` writes the traced iterations as a Chrome/Perfetto JSON
file there.

Under `distributed.devices=N` the ranks are spawned or joined as `run.py`
does (`parallel/mesh.py`) and each profiles its own shard; rank 0 prints
the line, its top-level keys rank 0's own, plus `world` (the global
env-steps/s: the run's env steps over the slowest rank's seconds, and the
ranks' operations over those seconds) and `ranks` (each rank's iteration
ms, kernel ms, busy share, ranges and ms an iteration of each kind of
collective, each between device syncs in the traced pass,
`mesh.collect_times`).
"""

from __future__ import annotations

import bisect
import json
import subprocess
import sys

import torch
from torch.autograd import DeviceType

from codebase_tpu_torch.algos import ac, dqn, dqn_train
from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.ops import fused_gru, grouped_dw, grouped_mm
from codebase_tpu_torch.parallel import mesh
from codebase_tpu_torch.run import build_envs, check_divides, check_keys
from codebase_tpu_torch.utils import profiling
from codebase_tpu_torch.utils.device import resolve_device

# each algorithm's family: its train functions and the ranges its iteration names
FAMILIES = {name: "dqn" for name in ("idqn", "vdn", "qmix")} | {
    name: "ac" for name in ("ia2c", "maa2c", "ippo", "mappo")
}
BUILDERS = {"dqn": dqn.build_train_functions, "ac": ac.build_train_functions}
RANGES = {
    "dqn": ("dqn/rollout", "dqn/reward_stream", "dqn/replay_add", "dqn/updates"),
    "ac": ("ac/rollout", "ac/reward_stream", "ac/update"),
}
# the spans inside the ranges of either family
SUB_RANGES = tuple(s for s in profiling.SPANS if s not in RANGES["dqn"] + RANGES["ac"])
# the profiler's keys: the port's schedule, the JAX package's (they do not
# mix), and the keys both take
PORT_SCHEDULE = ("warmup", "iters")
JAX_SCHEDULE = ("chunks", "chunk_iters")
PROFILE_KEYS = PORT_SCHEDULE + JAX_SCHEDULE + ("top", "trace_dir")
GRU_KERNELS = ("gru_fwd_kernel", "gru_bwd_kernel", "gru_fwd_wide_kernel", "gru_bwd_wide_kernel", "gru_dw_kernel",
               "gru_reduce_kernel")


def device_breakdown(events, iters: int, top: int, ranges) -> dict:
    """Kernel time (ms per iteration) from a trace's events.

    Only device-side events count (PyTorch's op events carry their kernels'
    time too, so summing those would count it twice). A kernel belongs to
    the range whose device-side span holds its start (the first of its
    group, in the group's order, where two do). `ranges` are the names of
    the family's ranges, which do not nest; the `SUB_RANGES` lie inside them
    and are attributed the same way, as a group of their own."""
    spans = {name: [] for name in (*ranges, *SUB_RANGES)}
    host_us = dict.fromkeys(spans, 0.0)
    by_name, kernels = {}, []
    total_us = 0.0
    for e in events:
        if e.name in spans:
            if e.device_type == DeviceType.CPU:
                host_us[e.name] += e.time_range.elapsed_us()
            else:
                spans[e.name].append((e.time_range.start, e.time_range.end))
            continue
        if e.device_type == DeviceType.CPU or getattr(e, "is_user_annotation", False):
            continue
        us = e.time_range.elapsed_us()
        total_us += us
        kernels.append((e.time_range.start, us))
        calls, acc = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, acc + us)
    span_us = {name: sum(end - start for start, end in ss) for name, ss in spans.items()}
    kernel_us = dict.fromkeys(spans, 0.0)
    for group in (ranges, SUB_RANGES):
        found = [(name, [start for start, _ in sorted(spans[name])], sorted(spans[name])) for name in group]
        for t, us in kernels:
            for name, starts, ss in found:
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and t < ss[i][1]:
                    kernel_us[name] += us
                    break
    ms = lambda us: us / 1e3 / iters  # noqa: E731
    ranked = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)

    def report(names):
        return {r: {"host_ms_per_iter_traced": ms(host_us[r]), "device_span_ms_per_iter": ms(span_us[r]),
                    "kernel_ms_per_iter": ms(kernel_us[r])} for r in names}

    return {
        "kernel_ms_per_iter": ms(total_us),
        "ranges": report(ranges),
        "sub_ranges": report(SUB_RANGES),
        "gru_kernel_ms_per_iter": {
            k: ms(sum(acc for n, (_, acc) in by_name.items() if k in n)) for k in GRU_KERNELS
        },
        "top_kernels": [
            {"name": n[:120], "calls_per_iter": calls / iters, "device_ms_per_iter": ms(acc)}
            for n, (calls, acc) in ranked[:top]
        ],
    }


def schedule(pcfg) -> tuple:
    """(warmup, timed, traced) iterations from the `profile` config node:
    the port's `warmup` (1) and `iters` (3), timed and traced alike, or the
    JAX package's `chunks` (4) x `chunk_iters` (8) timed after one chunk of
    warmup, one chunk traced. Raises ValueError on a key the profiler does
    not take, or on keys of both schedules."""
    if pcfg is None:
        pcfg = {}
    elif hasattr(pcfg, "to_dict"):
        pcfg = pcfg.to_dict()
    else:
        raise ValueError(f"profile must hold profile.* keys; got profile={pcfg!r}")
    unknown = sorted(set(pcfg) - set(PROFILE_KEYS))
    if unknown:
        raise ValueError(f"unknown profile keys {['profile.' + k for k in unknown]}; "
                         f"the profiler takes {['profile.' + k for k in PROFILE_KEYS]}")
    port, jax_keys = [k for k in PORT_SCHEDULE if k in pcfg], [k for k in JAX_SCHEDULE if k in pcfg]
    if port and jax_keys:
        raise ValueError(f"profile.{port[0]} and profile.{jax_keys[0]} do not mix: time with "
                         "profile.warmup/profile.iters or with profile.chunks/profile.chunk_iters")
    if jax_keys:
        chunks, chunk_iters = int(pcfg.get("chunks", 4)), int(pcfg.get("chunk_iters", 8))
        return chunk_iters, chunks * chunk_iters, chunk_iters
    iters = int(pcfg.get("iters", 3))
    return int(pcfg.get("warmup", 1)), iters, iters


def card(device) -> dict:
    """The card's name and its `nvidia-smi --query-gpu=name,power.limit`
    line; `{"name": "cpu", "nvidia_smi": None}` on the CPU."""
    if device.type != "cuda":
        return {"name": "cpu", "nvidia_smi": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return {"name": torch.cuda.get_device_name(device), "nvidia_smi": smi[0] if smi else None}


def _network_config(c) -> dict:
    return {"layers": list(c.layers), "use_rnn": c.use_rnn, "fused_rnn": str(c.get("fused_rnn", "auto"))}


def _model_config(family: str, acfg) -> dict:
    if family == "dqn":
        return {"batch_size": int(acfg.batch_size), **_network_config(acfg.model)}
    return {"actor": _network_config(acfg.model.actor),
            "critic": {**_network_config(acfg.model.critic), "centralised": bool(acfg.model.critic.centralised)},
            "num_epochs": int(acfg.get("num_epochs", 1)) if acfg.model.get("name") == "ppo" else 1}


def main(argv=None):
    """Profile the config's train iteration and print one JSON line (rank 0
    of a data-parallel run prints the run's); returns the report."""
    argv = list(argv if argv is not None else sys.argv[1:])
    cfg = load_config(argv)
    if not cfg.env.get("name") or not cfg.env.get("time_limit"):
        raise ValueError("env.name and env.time_limit must be set")
    name = cfg.get("algorithm", {}).get("name")
    if name not in FAMILIES:
        raise ValueError(f"unknown algorithm {name!r}; select one of {sorted(FAMILIES)} with +algorithm=")
    check_keys(cfg)
    schedule(cfg.get("profile"))
    device_name = cfg.get("device", "cuda")
    n_ranks = mesh.ranks_to_spawn(cfg.get("distributed"), device_name)
    if n_ranks:
        check_divides(cfg, n_ranks)
        return mesh.spawn(_rank_main, n_ranks, device_name, args=(argv,))[0]
    shard = mesh.mesh_from_config(cfg.get("distributed"), device_name)
    try:
        if shard is not None:
            check_divides(cfg, shard.world)
        report = _profile(cfg, name, shard)
        if shard is not None:
            report = _combine(report, shard)
    finally:
        mesh.release(shard)
    if shard is None or shard.rank == 0:
        print(json.dumps(report), flush=True)
    return report


def _rank_main(argv):
    """One spawned rank: profiles its shard; returns the run's report (rank
    0's is the one printed)."""
    return main(argv)


def _combine(report: dict, shard) -> dict:
    """Rank 0's report with `world` (the global env-steps/s: the whole run's
    steps over the slowest rank's seconds; the ranks' summed operations over
    those seconds) and `ranks` (each rank's numbers), gathered from every
    rank (a collective)."""
    mine = {k: report[k] for k in ("iteration_ms", "kernel_ms_per_iter", "device_busy_share", "ranges",
                                    "collective_ms_per_iter", "iteration_flops", "seconds", "steps")}
    mine["rank"] = shard.rank
    ranks = [None] * shard.world
    torch.distributed.all_gather_object(ranks, mine)
    slowest = max(r["seconds"] for r in ranks)
    report["world"] = {
        "ranks": shard.world,
        "backend": torch.distributed.get_backend(),
        "env_steps_per_s": report["steps"] / slowest,
        "tflops_per_s": sum(r["iteration_flops"] for r in ranks) * report["iters"] / slowest / 1e12,
        "slowest_rank_seconds": slowest,
    }
    report["ranks"] = ranks
    return report


def _profile(cfg, name, shard) -> dict:
    family = FAMILIES[name]
    pcfg = cfg.get("profile") or {}
    warmup, iters, traced_iters = schedule(cfg.get("profile"))
    top = int(pcfg.get("top", 15))
    trace_dir = pcfg.get("trace_dir")
    device = resolve_device(cfg.get("device", "cuda"))
    env, eval_env = build_envs(cfg)
    if "parallel_envs" in cfg.env:
        cfg.algorithm.parallel_envs = int(cfg.env.parallel_envs)
    T = int(cfg.env.time_limit)
    init_state, train_iteration = BUILDERS[family](env, eval_env, cfg.algorithm, T, device, shard=shard)[:2]
    state = init_state(int(cfg.get("seed") or 0))
    on_gpu = device.type == "cuda"
    read = dqn_train.read_loss if family == "dqn" else (lambda metrics: metrics)

    def run(n):
        window, = profiling.time_windows(lambda: read(train_iteration(state)), device, 1, n,
                                          lambda: (state.env_steps, state.updates))
        return window

    run(warmup)
    if on_gpu:
        torch.cuda.reset_peak_memory_stats(device)
    timed = run(iters)
    steps, seconds = timed["steps"], timed["seconds"]
    iteration_ms = seconds / iters * 1e3

    profiling.reset_counters()
    with profiling.host_spans() as spans:
        host_span_seconds = run(traced_iters)["seconds"]
    counts = profiling.counters()
    launches = fused_gru.launch_counts()
    linear_launches = {**grouped_dw.launch_counts(), **grouped_mm.launch_counts()}

    with profiling.count_operations() as ops:  # a pass of its own: its modes keep the env step eager
        run(traced_iters)
    if shard is not None:
        shard.times = {}  # each collective between device syncs, in the traced pass only
    with profiling.trace(trace_dir) as prof:
        traced_seconds = run(traced_iters)["seconds"]
    iteration_flops = ops["flops"] / traced_iters
    collectives = {k: s * 1e3 / traced_iters for k, (s, _) in shard.times.items()} if shard is not None else None
    if shard is not None:
        shard.times = None
    breakdown = device_breakdown(prof.events(), traced_iters, top, RANGES[family])
    measured = on_gpu and breakdown["kernel_ms_per_iter"] > 0
    if not measured:  # no device trace: keep the host ranges only
        for r in [*breakdown["ranges"].values(), *breakdown["sub_ranges"].values()]:
            r["device_span_ms_per_iter"] = r["kernel_ms_per_iter"] = None
        breakdown.update(kernel_ms_per_iter=None, gru_kernel_ms_per_iter=None, top_kernels=None)
    report = {
        "algorithm": name,
        "env": str(cfg.env.name),
        "card": card(device),
        "config": {"algorithm": name, "env": cfg.env.name, "time_limit": T,
                   "parallel_envs": int(cfg.algorithm.get("parallel_envs", 1)),
                   "standardise_rewards": bool(cfg.env.get("standardise_rewards")),
                   "standardise_returns": bool(cfg.algorithm.get("standardise_returns")),
                   **_model_config(family, cfg.algorithm)},
        "iters": iters,
        "steps": steps,
        "seconds": seconds,
        "env_steps_per_s": steps / seconds,
        "updates_per_s": timed["updates"] / seconds,
        "iteration_ms": iteration_ms,
        "traced_iters": traced_iters,
        "traced_iteration_ms": traced_seconds / traced_iters * 1e3,
        "device_busy_share": breakdown["kernel_ms_per_iter"] / iteration_ms if measured else None,
        "iteration_flops": iteration_flops,
        "tflops_per_s": iteration_flops / (iteration_ms / 1e3) / 1e12,
        "host_span_iteration_ms": host_span_seconds / traced_iters * 1e3,
        "host_spans": spans.report(traced_iters),
        "policy_steps_per_iter": counts.get("rollout/policy_steps", 0) / traced_iters,
        "env_steps_by_path_per_iter": {k: counts.get(f"env/step_{k}", 0) / traced_iters
                                       for k in ("graph_captures", "graph_replays", "eager")},
        "syncs_per_iter": {k: counts[k] / traced_iters
                           for k in sorted(k for k in counts if isinstance(k, str) and k.startswith("sync/"))},
        "gru_calls_per_iter": [
            {"direction": key[0].split("/")[1], **dict(zip("GTBH", key[1])), "calls": v / traced_iters}
            for key, v in sorted(counts.items(), key=str) if isinstance(key, tuple) and key[0].startswith("gru/")
        ],
        "gru_launches_per_iter": {k: v / traced_iters for k, v in launches.items()},
        "linear_dw_calls_per_iter": [
            {"route": key[1], **dict(zip("GKMN", key[2])), "calls": v / traced_iters}
            for key, v in sorted(counts.items(), key=str) if isinstance(key, tuple) and key[0] == "linear/dw"
        ],
        "linear_mm_calls_per_iter": [
            {"direction": key[0].split("/")[1], "route": key[1], **dict(zip("GRKN", key[2])), "calls": v / traced_iters}
            for key, v in sorted(counts.items(), key=str)
            if isinstance(key, tuple) and key[0] in grouped_mm.COUNTERS
        ],
        "linear_launches_per_iter": {k: v / traced_iters for k, v in linear_launches.items()},
        "mixer_calls_per_iter": [
            {**dict(zip("UKS", key[1])), "calls": v / traced_iters}
            for key, v in sorted(counts.items(), key=str) if isinstance(key, tuple) and key[0] == "qmix/mixer"
        ],
        "peak_device_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30 if on_gpu else None,
        "collective_ms_per_iter": collectives,
        **breakdown,
    }
    if trace_dir:
        report["trace_dir"] = str(trace_dir)
    return report


if __name__ == "__main__":
    main()
