"""Profiling CLI — where one training iteration's time goes, on the GPU.

    python -m codebase_tpu_torch.profile +algorithm=idqn|vdn|qmix|ia2c|maa2c|ippo|mappo \
        env.name=... env.time_limit=25 \
        [profile.warmup=1] [profile.iters=3] [profile.top=15] [any run override]

Builds the train iteration for the config, runs `warmup` iterations, times
`iters` iterations on the host clock (each ends in a device sync), then runs
`iters` more under `torch.profiler` and prints one JSON line: the card and its
power limit, env-steps/s and iteration time untraced, the device time of
every kernel (kernels, copies and fills, each counted once) per iteration,
split over the iteration's named ranges (the value-based family's
`dqn/rollout`, `dqn/reward_stream` when the env stack standardises rewards,
`dqn/replay_add` and `dqn/updates`; the actor-critic family's `ac/rollout`,
`ac/reward_stream` and `ac/update`) and the sub-range `env/step` (the env
steps inside the rollout, the rest of it being the policy), the device's
busy share, the GRU kernels' launches and time, the kernels with the most
device time, and the peak device memory.

The busy share is kernel time over the untraced iteration time: tracing
slows the host's launch loop (`traced_iteration_ms`) but not the kernels.
Device numbers need `device=cuda`; on the CPU they read null.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

from codebase_tpu_torch.algos import ac, dqn
from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.ops import fused_gru
from codebase_tpu_torch.run import build_envs
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
SUB_RANGES = ("env/step",)  # inside the rollout range of either family
GRU_KERNELS = ("gru_fwd_kernel", "gru_bwd_kernel", "gru_fwd_wide_kernel", "gru_bwd_wide_kernel", "gru_dw_kernel",
               "gru_reduce_kernel")


def device_breakdown(events, iters: int, top: int, ranges) -> dict:
    """Kernel time (ms per iteration) from a trace's events.

    Only device-side events count (PyTorch's op events carry their kernels'
    time too, so summing those would count it twice). A kernel belongs to
    the range whose device-side span holds its start. `ranges` are the
    names of the family's ranges, which do not nest; the `SUB_RANGES` lie
    inside them and are attributed the same way, on their own."""
    named = set(ranges) | set(SUB_RANGES)

    def device_spans(names):
        return [(e.name, e.time_range.start, e.time_range.end)
                for e in events if e.name in names and e.device_type != DeviceType.CPU]

    spans, sub_spans = device_spans(ranges), device_spans(SUB_RANGES)
    host_us = dict.fromkeys(named, 0.0)
    span_us = dict.fromkeys(named, 0.0)
    kernel_us = dict.fromkeys(named, 0.0)
    for name, start, end in spans + sub_spans:
        span_us[name] += end - start
    by_name = {}
    total_us = 0.0
    for e in events:
        if e.name in named:
            if e.device_type == DeviceType.CPU:
                host_us[e.name] += e.time_range.elapsed_us()
            continue
        if e.device_type == DeviceType.CPU or getattr(e, "is_user_annotation", False):
            continue
        us = e.time_range.elapsed_us()
        total_us += us
        calls, acc = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, acc + us)
        for group in (spans, sub_spans):
            for name, start, end in group:
                if start <= e.time_range.start < end:
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


def _card(device) -> dict:
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
    cfg = load_config(argv if argv is not None else sys.argv[1:])
    if not cfg.env.get("name") or not cfg.env.get("time_limit"):
        raise ValueError("env.name and env.time_limit must be set")
    name = cfg.get("algorithm", {}).get("name")
    if name not in FAMILIES:
        raise ValueError(f"unknown algorithm {name!r}; select one of {sorted(FAMILIES)} with +algorithm=")
    family = FAMILIES[name]
    pcfg = cfg.get("profile") or {}
    warmup, iters, top = (int(pcfg.get(k, d)) for k, d in (("warmup", 1), ("iters", 3), ("top", 15)))
    device = resolve_device(cfg.get("device", "cuda"))
    env, eval_env = build_envs(cfg)
    if "parallel_envs" in cfg.env:
        cfg.algorithm.parallel_envs = int(cfg.env.parallel_envs)
    T = int(cfg.env.time_limit)
    init_state, train_iteration = BUILDERS[family](env, eval_env, cfg.algorithm, T, device)[:2]
    state = init_state(int(cfg.get("seed") or 0))
    on_gpu = device.type == "cuda"

    def sync():
        if on_gpu:
            torch.cuda.synchronize(device)

    def run(n):
        steps0 = state.env_steps
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            float(train_iteration(state)["loss"])
        sync()
        return state.env_steps - steps0, time.perf_counter() - t0

    run(warmup)
    if on_gpu:
        torch.cuda.reset_peak_memory_stats(device)
    steps, seconds = run(iters)
    iteration_ms = seconds / iters * 1e3

    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_gpu:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    fused_gru.reset_launch_counts()
    with torch.profiler.profile(activities=activities) as prof:
        _, traced_seconds = run(iters)
    launches = fused_gru.launch_counts()
    breakdown = device_breakdown(prof.events(), iters, top, RANGES[family])
    measured = on_gpu and breakdown["kernel_ms_per_iter"] > 0
    if not measured:  # no device trace: keep the host ranges only
        for r in [*breakdown["ranges"].values(), *breakdown["sub_ranges"].values()]:
            r["device_span_ms_per_iter"] = r["kernel_ms_per_iter"] = None
        breakdown.update(kernel_ms_per_iter=None, gru_kernel_ms_per_iter=None, top_kernels=None)
    report = {
        "card": _card(device),
        "config": {"algorithm": name, "env": cfg.env.name, "time_limit": T,
                   "parallel_envs": int(cfg.algorithm.get("parallel_envs", 1)),
                   "standardise_rewards": bool(cfg.env.get("standardise_rewards")),
                   "standardise_returns": bool(cfg.algorithm.get("standardise_returns")),
                   **_model_config(family, cfg.algorithm)},
        "iters": iters,
        "env_steps_per_s": steps / seconds,
        "iteration_ms": iteration_ms,
        "traced_iteration_ms": traced_seconds / iters * 1e3,
        "device_busy_share": breakdown["kernel_ms_per_iter"] / iteration_ms if measured else None,
        "gru_launches_per_iter": {k: v / iters for k, v in launches.items()},
        "peak_device_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30 if on_gpu else None,
        **breakdown,
    }
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
