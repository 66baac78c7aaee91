"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (`codebase_tpu_torch`).
The run builds the cell's train state through the family that its
configuration names (`families/<family>.py`: the program's
`build_train_functions` from the composed config, the envs from
`run.build_envs`), fills its weights on the card from the seed, drives the
first train iteration with the family's taps, warms up one more iteration,
then calls `train_iteration(state)` as the port's host loop does (a device
sync, the iteration, the loss read back) until `--seconds` have passed, and
ends the window in a device sync. With `--trace 1` a few more iterations
then run under `torch.profiler`, read in memory (`trace.py`). Once the
window has closed and the peak memory has been read, the family's exact
checks run a last iteration or two, the program's state is freed and the
plain reference judges what the taps recorded.

The last line of standard output is one JSON object: `correct`,
`attempted` (the window's iterations), `failed`, `metrics` (the cell's
end-to-end metrics untraced, its per-layer metrics traced), `device`,
`breakdown` (traced) and `checks`, each number compared with its limit;
the same numbers end standard error. No card, too few cards, or JAX in the
process after the window: exit 2, and no result.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# the JAX side of the repository, by whole top-level module names
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "codebase_tpu")
WARMUP_ITERS = 1  # after the checked first iteration
TRACED_ITERS = 3


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def compose(workload: dict, config: dict, seed: int, device: str) -> list:
    """The port's config overrides for a cell: the configuration's preset,
    env and overrides, then the traffic's."""
    traffic = workload["traffic"]
    argv = [f"+algorithm={config['preset']}", f"env.name={config['env']}", f"env.time_limit={config['time_limit']}",
            *config["overrides"], f"seed={seed}", f"device={device}"]
    envs = int(traffic["parallel_envs"])
    argv += [f"env.parallel_envs={envs}", f"algorithm.parallel_envs={envs}"]
    argv += [f"algorithm.{k}={v}" for k, v in traffic.items() if k != "parallel_envs"]
    return argv


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


# train iterations the harness ran since the process started (the checked
# first iteration, warm-up, window, traced stretch and after-window checks)
ITERATIONS = {"run": 0}


class Cell:
    """One cell's train state (its family's, `families/`), built, weighted
    from the seed and driven through its checked first iteration."""

    def __init__(self, workload: dict, config: dict, seed: int, device_name: str):
        from codebase_tpu_torch.config import load_config
        from codebase_tpu_torch.run import build_envs
        from codebase_tpu_torch.utils.device import resolve_device

        from portbench import families

        self.family = families.load(config["family"])
        self.marks = [("program imports", time.perf_counter())]
        cfg = load_config(compose(workload, config, seed, device_name))
        self.device = resolve_device(device_name)  # also turns TF32 off for f32 products
        env, eval_env = build_envs(cfg)
        self.marks.append(("config and envs", time.perf_counter()))
        self.reference = config["reference"]
        self.iters = 0
        self.train = self.family.Train(cfg, env, eval_env, self.device, workload["traffic"], seed)
        self.marks.append(("train state", time.perf_counter()))
        self.w0 = self.train.make_weights(seed)
        with self.train.taps(seed, self.reference) as self.taps:
            self.iterate()
        self.taps.finish()
        sync(self.device)
        self.marks.append(("weights and the checked iteration", time.perf_counter()))

    def iterate(self) -> None:
        """One iteration as the port's host loop runs it."""
        sync(self.device)
        self.train.read_back(self.train.train_iteration(self.train.state))
        self.iters += 1
        ITERATIONS["run"] += 1

    def env_steps(self) -> int:
        return self.train.env_steps()

    def judge(self, mode: str = "program") -> dict:
        """The numbers compared (`families/<family>.judge`), once the
        program's state is freed."""
        return self.family.judge(self.taps, self.w0, self.reference, self.device, mode)

    def free(self) -> None:
        self.train.free()
        if self.device.type == "cuda":
            import torch

            torch.cuda.empty_cache()


def measure(cell: Cell, seconds: float) -> dict:
    """Whole train iterations from a device sync until `seconds` have
    passed, ending in a device sync: all the env steps over all the time."""
    sync(cell.device)
    steps0, t0 = cell.env_steps(), time.perf_counter()
    marks = [t0]
    while marks[-1] - t0 < seconds:
        cell.iterate()
        marks.append(time.perf_counter())
    sync(cell.device)
    t1 = time.perf_counter()
    return {"start": t0, "seconds": t1 - t0, "iters": len(marks) - 1, "env_steps": cell.env_steps() - steps0,
            "iteration_s": [b - a for a, b in zip(marks[:-1], marks[1:])]}


def traced(cell: Cell, iters: int):
    """`iters` iterations under the profiler: (trace summary, seconds). The
    program's ranges read are the cell's family's, and `env/step`."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cell.device.type == "cuda" else [])
    sync(cell.device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            cell.iterate()
        sync(cell.device)
        seconds = time.perf_counter() - t0
    return trace.summarise(prof.events(), iters, (*cell.family.RANGES.values(), "env/step")), seconds


def run_cell(name: str, seed: int, seconds: float, trace: bool, device_name: str = "cuda",
             bench: dict = None, workload: dict = None, config: dict = None):
    """One run of cell `name`; returns (result, lines for standard error).
    `workload` and `config` default to the cell's files."""
    import torch

    from portbench import check, counts, spec

    marks = [("start", PROCESS_START), ("torch import", time.perf_counter())]
    bench = bench or spec.benchmark()
    workload = workload or spec.workload(name)
    config = config or spec.config(workload["config"])
    on_card = device_name == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    marks.append(("the card", time.perf_counter()))
    cell = Cell(workload, config, seed, device_name)
    for _ in range(WARMUP_ITERS):
        cell.iterate()
    cell.marks.append(("warm-up", time.perf_counter()))
    window = measure(cell, seconds)
    setup_s = window["start"] - PROCESS_START
    summary = traced_s = None
    if trace:
        summary, traced_s = traced(cell, TRACED_ITERS)
    peak_bytes = torch.cuda.max_memory_allocated() if on_card else 0
    exact = cell.train.after_window(cell)
    rollout_flops, update_flops = cell.train.useful_flops()
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    peaks = counts.PEAKS.get(kind)
    ctx = {
        "window": window, "setup_s": setup_s, "peak_bytes": peak_bytes, "trace": summary,
        "flops": {"rollout_per_env_step": rollout_flops, "updates_per_iter": update_flops},
        "dtype": config["dtype"], "peaks": peaks, "ranges": cell.family.RANGES,
        "iterations": cell.train.iterations(ITERATIONS["run"]),
        "gru_least_seconds": (lambda calls: cell.train.gru_least_seconds(calls, peaks)) if peaks else None,
    }
    cell.free()
    judged = time.perf_counter()
    numbers = cell.judge()
    judged = time.perf_counter() - judged
    numbers.update(exact)
    correct, checks = check.verdict(numbers, config["limits"])
    metrics = {}
    for mname in spec.run_metrics(bench, trace):
        mod = spec.metric(mname)
        value = mod.read(ctx)
        if value is not None:
            metrics[mname] = {"value": value, "unit": mod.UNIT}
    device = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": int(workload["chips"]),
              "memory_peak_bytes": int(peak_bytes)}
    result = {"correct": correct, "attempted": window["iters"], "failed": 0 if correct else window["iters"],
              "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = summary["busy_us"] / 1e6
        device["window_s"] = traced_s
        top = sorted(summary["by_name"].items(), key=lambda kv: -kv[1][1])[:10]
        result["breakdown"] = {
            "device_ops": [[n[:200], us * summary["iters"] / 1e6] for n, (_, us) in top],
            "idle_gaps": [[n[:200], s] for n, s in summary["idle_gaps"][:10]],
        }
    result["checks"] = checks
    its = sorted(window["iteration_s"])
    marks += cell.marks
    lines = ["set-up s: " + ", ".join(f"{name} {b - a:.2f}" for (_, a), (name, b) in zip(marks[:-1], marks[1:]))]
    lines += [f"window: {window['iters']} iterations in {window['seconds']:.4f} s, iteration ms min "
             f"{1e3 * its[0]:.2f} median {1e3 * its[len(its) // 2]:.2f} max {1e3 * its[-1]:.2f}",
              f"reference s: {judged:.2f}"]
    lines += [f"check {k}: {v} (limit {lim})" for k, (v, lim) in checks.items()]
    if cell.taps.env_first_mismatch:
        lines.insert(0, f"first env mismatch: {cell.taps.env_first_mismatch}")
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import spec

    bench = spec.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); this machine shows "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", bench)
    found = forbidden_modules()
    if found:
        print(f"the process holds the JAX side after the window: {found}", file=sys.stderr)
        return 2
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
