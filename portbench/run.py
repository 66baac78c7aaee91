"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (`codebase_tpu_torch`).
The run builds the cell's train state (`algos/dqn.build_train_functions`
from the composed config, the envs from `run.build_envs`), fills its
weights on the card from the seed, drives the first train iteration with
the check's taps (`check.py`), warms up one more iteration, then calls
`train_iteration(state)` as the port's host loop does (a device sync, the
iteration, the loss read back) until `--seconds` have passed, and ends the
window in a device sync. With `--trace 1` a few more iterations then run
under `torch.profiler`, read in memory (`trace.py`). Once the window has
closed and the peak memory has been read, the program's state is freed and
the plain reference judges what the taps recorded.

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
import gc  # noqa: E402
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


class Cell:
    """One cell's train state, built, weighted from the seed and driven
    through its checked first iteration and warm-up."""

    def __init__(self, workload: dict, config: dict, seed: int, device_name: str):
        from codebase_tpu_torch.algos.dqn import build_train_functions
        from codebase_tpu_torch.config import load_config
        from codebase_tpu_torch.run import build_envs
        from codebase_tpu_torch.utils.device import resolve_device

        from portbench import check

        self.marks = [("program imports", time.perf_counter())]
        cfg = load_config(compose(workload, config, seed, device_name))
        self.device = resolve_device(device_name)  # also turns TF32 off for f32 products
        self.cfg = cfg
        env, eval_env = build_envs(cfg)
        self.marks.append(("config and envs", time.perf_counter()))
        self.env = env
        self.T = int(cfg.env.time_limit)
        self.n_envs = int(cfg.algorithm.parallel_envs)
        self.updates_per_iter = int(workload["traffic"]["updates_per_collect"])
        self.iters = 0
        init_state, self.train_iteration, _ = build_train_functions(env, eval_env, cfg.algorithm, self.T, self.device)
        self.state = init_state(seed)
        self.marks.append(("train state", time.perf_counter()))
        self.w0 = check.make_weights(self.state.model.param_tree(), self.state.target.param_tree(), seed,
                                     self.device)
        with check.Taps(self.state, env, self.n_envs, seed, int(config["reference"].get("check_rows", 256))) as self.taps:
            self.iterate()
        self.taps.finish()
        sync(self.device)
        self.marks.append(("weights and the checked iteration", time.perf_counter()))

    def iterate(self) -> None:
        """One iteration as the port's host loop runs it."""
        sync(self.device)
        metrics = self.train_iteration(self.state)
        float(metrics["loss"])  # the host loop reads the loss back, which waits for the updates
        self.iters += 1

    def env_steps(self) -> int:
        return int(self.state.env_steps)

    def model(self) -> dict:
        """What the useful-flops count needs, from the configuration."""
        acfg = self.cfg.algorithm
        model = {"obs_dims": list(self.env.obs_dims), "action_dims": list(self.env.action_dims),
                 "layers": list(acfg.model.layers), "use_rnn": bool(acfg.model.use_rnn)}
        if acfg.model.name == "qmix":
            mx = acfg.model.mixing
            model["mixer"] = {"n_agents": self.env.n_agents, "state_dim": sum(self.env.obs_dims),
                              "embed_dim": int(mx.embed_dim), "hypernet_layers": int(mx.hypernet_layers),
                              "hypernet_embed": int(mx.hypernet_embed)}
        return model

    def target_copies(self, interval: int) -> dict:
        """After the window, whether the hard target copies come when due
        and copy the online parameters. `target_schedule`: the program's
        update count off the iterations run, plus its last copy off the last
        multiple of `interval` (both 0). Then the program's counter is set
        so that a copy falls due at the last update of one more iteration,
        and `target_copy_gap` is the largest gap between the target and the
        online parameters after it (a copy: 0)."""
        state, per_iter = self.state, self.updates_per_iter
        n, last = int(state.updates), int(state.last_target_update)
        schedule = abs(n - per_iter * self.iters) + abs(last - interval * (n // interval))
        state.last_target_update = n + per_iter - interval
        self.iterate()
        gap = max(float((t - p).detach().abs().max())
                  for t, p in zip(state.target.param_leaves(), state.model.param_leaves()))
        return {"target_schedule": float(schedule), "target_copy_gap": gap}

    def free(self) -> None:
        del self.state, self.train_iteration
        gc.collect()
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
    """`iters` iterations under the profiler: (trace summary, seconds)."""
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
    return trace.summarise(prof.events(), iters), seconds


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
    copies = cell.target_copies(int(config["model"]["target_update_interval_or_tau"]))
    traffic = workload["traffic"]
    model = cell.model()
    rollout_flops, update_flops = counts.useful_flops(model, cell.T, traffic["batch_size"],
                                                      traffic["updates_per_collect"])
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    ctx = {
        "window": window, "setup_s": setup_s, "peak_bytes": peak_bytes, "trace": summary,
        "flops": {"rollout_per_env_step": rollout_flops, "updates_per_iter": update_flops},
        "dtype": config["dtype"], "peaks": counts.PEAKS.get(kind),
        "shapes": {"T": cell.T, "E": cell.n_envs, "B": int(traffic["batch_size"]),
                   "U": int(traffic["updates_per_collect"]), "G": len(model["obs_dims"]),
                   "H": int(model["layers"][0])},
    }
    cell.free()
    numbers = check.judge(cell.taps, cell.w0, config["reference"], cell.device)
    numbers.update(copies)
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
             f"{1e3 * its[0]:.2f} median {1e3 * its[len(its) // 2]:.2f} max {1e3 * its[-1]:.2f}"]
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
