"""Hyperparameter sweep CLI, the port's copy of the JAX package's
`codebase_tpu/search.py` with the same sweep-spec format and command line:

    python -m codebase_tpu_torch.search run --config sweeps/sample.yaml --seeds 5 <mode>

Spec format (the reference's, `configs/sweeps/sample.yaml`):
- scalar values are constants,
- list values are grid axes (cartesian product),
- `!!python/tuple` entries link parameters (merged together; nested lists
  inside a tuple expand as further grid axes).

Modes:
- `dry_run`  — print the generated combination list,
- `single I` — run one combination, for cluster array jobs,
- `locally`  — run combinations as `run.py` invocations: sequentially in
  this process by default, or `--workers N` concurrent `python -m
  codebase_tpu_torch.run` subprocesses, which may share one GPU,
- `vmapped`  — group the combinations by their residual config and train
  all (hyper-variant x seed) units of a group together in one train state
  (`sweep.py`): every kernel launch serves all units of the group,
- `bayes`    — Gaussian-process Bayesian optimisation over the spec's grid
  (`bayes.py`), each evaluation a `vmapped` group of all seeds.

The command line is built with `argparse` and `results.csv` is read with
`csv`, so the port needs neither click nor pandas. The JAX package enables
XLA's persistent compilation cache before `vmapped` and `bayes`; the port
has no compiled programs to cache (its kernels are built once per process,
`ops/fused_gru.py`), so it has no counterpart.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import math
import random
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from copy import deepcopy
from itertools import product
from pathlib import Path

import numpy as np
import yaml

log = logging.getLogger("codebase_tpu_torch")


class _SweepLoader(yaml.SafeLoader):
    pass


def _tuple_constructor(loader, node):
    return tuple(loader.construct_sequence(node))


_SweepLoader.add_constructor("tag:yaml.org,2002:python/tuple", _tuple_constructor)


def load_spec(text):
    """A sweep spec (YAML text or stream) with `!!python/tuple` entries."""
    return yaml.load(text, Loader=_SweepLoader)


def _flatten_lists(obj):
    for item in obj:
        if isinstance(item, (list, tuple, set)):
            yield from _flatten_lists(item)
        else:
            yield item


def gen_combos(config: dict, built: dict | None = None):
    """Cartesian expansion with tuple-linked params."""
    built = deepcopy(built or {})
    if not config:
        return [[f"{k}={v}" for k, v in built.items()]]
    k, v = next(iter(config.items()))
    combos = []
    if isinstance(v, list):
        for item in v:
            new = deepcopy(config)
            del new[k]
            new[k] = item
            combos += gen_combos(new, built)
    elif isinstance(v, tuple):
        new = deepcopy(config)
        del new[k]
        for item in v:
            new.update(item)
        combos += gen_combos(new, built)
    else:
        new = deepcopy(config)
        del new[k]
        built[k] = v
        combos += gen_combos(new, built)
    return combos


def seed_and_shuffle(combos, shuffle: bool, seeds: int):
    """Tag hypergroups, cross with seeds, deterministic shuffle."""
    combos = [[f"+hypergroup=hp_grp_{i}"] + c for i, c in enumerate(combos)]
    combos = list(product(combos, [f"seed={i}" for i in range(seeds)]))
    combos = [list(_flatten_lists(c)) for c in combos]
    if shuffle:
        random.Random(1337).shuffle(combos)
    return combos


# categorical level standing for "key not present in this combo" (tuple-linked
# sweep specs legitimately produce such holes); _parse_scalar passes it through
# as a string, so the GP encoder one-hots the axis
_ABSENT = "<absent>"


def _parse_scalar(v: str):
    try:
        f = float(v)
        return int(f) if f.is_integer() and "." not in str(v) and "e" not in str(v).lower() else f
    except (TypeError, ValueError):
        return v


def _axis_sort_key(v):
    p = _parse_scalar(v)
    return (0, p, "") if isinstance(p, (int, float)) else (1, 0, str(p))


def _confirm(text: str) -> None:
    """Ask on stdin; anything but y/yes aborts with exit code 1."""
    try:
        answer = input(f"{text} [y/N]: ")
    except EOFError:
        answer = ""
    if answer.strip().lower() not in ("y", "yes"):
        print("Aborted!", file=sys.stderr)
        raise SystemExit(1)


def _logging():
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")


# ---------------------------------------------------------------- the modes


def dry_run(combos, args):
    print(f"There are {len(combos)} configurations as shown below:")
    for c in combos:
        print(" ".join(c))


def single(combos, args):
    """Run one combination by INDEX (cluster array jobs)."""
    from codebase_tpu_torch.run import main as run_main

    tokens = list(combos[args.index])
    print(" ".join(tokens))
    run_main(tokens)


def locally(combos, args):
    """Run every combination: sequentially in this process by default, or
    as a pool of `--workers` run subprocesses."""
    workers = args.workers
    if not args.yes:
        _confirm(f"Run {len(combos)} combinations " + (f"with {workers} workers?" if workers > 1 else "sequentially?"))
    if workers <= 1:
        from codebase_tpu_torch.run import main as run_main

        for i, tokens in enumerate(combos):
            print(f"[{i + 1}/{len(combos)}] " + " ".join(tokens))
            run_main(list(tokens))
        return

    def work(i_tokens):
        i, tokens = i_tokens
        print(f"[{i + 1}/{len(combos)}] " + " ".join(tokens))
        proc = subprocess.run(
            [sys.executable, "-m", "codebase_tpu_torch.run", *tokens], capture_output=True, text=True
        )
        if proc.returncode != 0:
            print(f"[{i + 1}/{len(combos)}] FAILED rc={proc.returncode}\n" + proc.stderr[-2000:], file=sys.stderr)
        return proc.returncode

    # threads only marshal subprocesses; each run has its own process
    with ThreadPoolExecutor(max_workers=workers) as pool:
        codes = list(pool.map(work, enumerate(combos)))
    failed = sum(1 for c in codes if c != 0)
    print(f"done: {len(codes) - failed}/{len(codes)} succeeded")
    if failed:
        raise SystemExit(1)


def vmapped_groups(combos):
    """Group combinations by their residual config (the `VMAPPABLE_KEYS`
    assignments, seeds and hypergroup tags stripped): {sorted residual
    tokens: {"tokens", "variants" (in first-seen order), "seeds" (a set)}}."""
    from codebase_tpu_torch.sweep import VMAPPABLE_KEYS

    groups: dict[tuple, dict] = {}
    for tokens in combos:
        seed = int(next(t.split("=")[1] for t in tokens if t.startswith("seed=")))
        base = [t for t in tokens if not t.startswith(("seed=", "+hypergroup"))]
        variant = {}
        residual = []
        for t in base:
            k, _, v = t.partition("=")
            if k in VMAPPABLE_KEYS:
                variant[VMAPPABLE_KEYS[k]] = float(v)
            else:
                residual.append(t)
        g = groups.setdefault(tuple(sorted(residual)), {"tokens": residual, "variants": [], "seeds": set()})
        if variant not in g["variants"]:
            g["variants"].append(variant)
        g["seeds"].add(seed)
    return groups


def vmapped(combos, args):
    """Fold sweep axes into groups trained together.

    Seeds always fold. Grid axes on scalar hyperparameters that change no
    shape (`sweep.VMAPPABLE_KEYS`: lr, gamma, tau) fold into the same
    group, so an lr grid x seeds trains every combination in one train
    state on one GPU. Axes that change shapes or static structure remain a
    loop of separate groups."""
    from codebase_tpu_torch.config import load_config
    from codebase_tpu_torch.sweep import run_vmapped_multiseed

    _logging()
    groups = vmapped_groups(combos)
    n_units = sum(len(g["variants"]) * len(g["seeds"]) for g in groups.values())
    if not args.yes:
        _confirm(f"Run {len(groups)} compiled group(s) covering {n_units} vmapped (variant x seed) units?")
    for i, (_, info) in enumerate(sorted(groups.items())):
        cfg = load_config(info["tokens"])
        variants = info["variants"] if any(info["variants"]) else None
        print(
            f"group_{i}: {' '.join(info['tokens'])} "
            f"(variants {variants or '[default]'}, seeds {sorted(info['seeds'])})"
        )
        run_vmapped_multiseed(cfg, sorted(info["seeds"]), Path(args.output) / f"group_{i}", hyper_variants=variants)


def read_metric(path: Path, metric: str) -> list:
    """The `metric` column of a results.csv as floats, empty and NaN cells
    dropped (what pandas' `read_csv(...)[metric].dropna()` keeps). A missing
    column raises KeyError."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if rows and metric not in rows[0]:
        raise KeyError(metric)
    values = [float(r[metric]) for r in rows if r.get(metric) not in (None, "")]
    return [v for v in values if not math.isnan(v)]


def bayes(combos, args):
    """Bayesian optimisation over the sweep spec (GP + expected improvement).

    Candidates are the spec's grid; instead of exhausting it, a Gaussian
    process proposes the next configuration and stops at --budget
    evaluations. Each evaluation trains all seeds of the configuration
    together (`sweep.py`); the objective is the seed-mean of the final
    `--metric` (tail-averaged)."""
    from codebase_tpu_torch.bayes import optimise
    from codebase_tpu_torch.config import load_config
    from codebase_tpu_torch.sweep import run_vmapped_multiseed

    _logging()
    # a spec with no seed axis still evaluates: default to one seed
    seeds = sorted({int(t.split("=")[1]) for c in combos for t in c if t.startswith("seed=")}) or [0]
    combo_dicts = {}
    for tokens in combos:
        d = {}
        for t in tokens:
            if t.startswith(("seed=", "+hypergroup")):
                continue
            k, _, v = t.partition("=")
            d[k] = v
        combo_dicts[tuple(sorted(d.items()))] = d
    candidates = list(combo_dicts.values())
    keys = sorted({k for c in candidates for k in c})
    # tuple-linked specs produce heterogeneous key sets (a key present in
    # only some combos): absence is itself a categorical level, not a KeyError
    axes = {}
    for k in keys:
        vals = {c.get(k, _ABSENT) for c in candidates}
        if len(vals) > 1:
            axes[k] = sorted(vals, key=_axis_sort_key)
    # typed axes for the encoder (numeric strings -> floats)
    axes_typed = {k: [_parse_scalar(v) for v in vs] for k, vs in axes.items()}

    budget = args.budget
    if not args.yes:
        _confirm(
            f"Bayesian-optimise over {len(candidates)} candidates "
            f"({budget} evaluations x {len(seeds)} vmapped seeds)?"
        )

    out_root = Path(args.output)
    trial = {"i": 0}

    def evaluate(combo):
        trial["i"] += 1
        tokens = [f"{k}={v}" for k, v in combo.items()]
        cfg = load_config(tokens)
        d = out_root / f"trial_{trial['i']:03d}"
        print(f"[bayes {trial['i']}/{budget}] {' '.join(tokens)}")
        dirs = run_vmapped_multiseed(cfg, seeds, d)
        finals = []
        for sd in dirs:
            vals = read_metric(sd / "results.csv", args.metric)[-args.tail:] if args.tail > 0 else []
            finals.append(float(np.mean(vals)) if vals else math.nan)
        y = float(np.mean(finals))
        print(f"[bayes {trial['i']}/{budget}] objective {y:.4f}")
        return y

    # only the varying axes feed the GP; constants ride along in evaluate
    bo_candidates = [{k: _parse_scalar(c.get(k, _ABSENT)) for k in axes} for c in candidates]
    raw_by_enc = {tuple(sorted(b.items())): c for b, c in zip(bo_candidates, candidates)}

    result = optimise(
        bo_candidates,
        axes_typed,
        lambda b: evaluate(raw_by_enc[tuple(sorted(b.items()))]),
        budget,
        seed=args.bo_seed,
    )
    summary = {
        "best": raw_by_enc[tuple(sorted(result["best"].items()))],
        "best_value": result["best_value"],
        "evaluations": len(result["history"]),
        "candidates": len(candidates),
        "metric": args.metric,
    }
    out_root.mkdir(parents=True, exist_ok=True)
    (out_root / "bayes_result.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))


# -------------------------------------------------------------- the parser


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m codebase_tpu_torch.search")
    commands = parser.add_subparsers(dest="command", required=True)
    run = commands.add_parser("run", help="expand a sweep spec and run it in one of the modes")
    run.add_argument("--config", default="config.yaml", help="the sweep spec (YAML)")
    run.add_argument("--shuffle", dest="shuffle", action="store_true", default=True)
    run.add_argument("--no-shuffle", dest="shuffle", action="store_false")
    run.add_argument("--seeds", type=int, default=3, help="How many seeds to run  [default: 3]")
    modes = run.add_subparsers(dest="mode", required=True)

    # click spells the JAX package's command `dry-run`; both spellings work
    modes.add_parser("dry_run", aliases=["dry-run"], help="print the combinations").set_defaults(fn=dry_run)

    p = modes.add_parser("single", help="run one combination by INDEX (cluster array jobs)")
    p.add_argument("index", type=int)
    p.set_defaults(fn=single)

    p = modes.add_parser("locally", help="run every combination locally")
    p.add_argument("--yes", action="store_true", help="skip confirmation")
    p.add_argument(
        "--workers", type=int, default=1,
        help="concurrent `python -m codebase_tpu_torch.run` subprocesses (the reference's process pool); "
        "several may share one GPU, each its own process. 1 (the default) runs the combinations one "
        "after another in this process; axes that can fold into `vmapped` train faster there.",
    )
    p.set_defaults(fn=locally)

    p = modes.add_parser("vmapped", help="train each group's (variant x seed) units together")
    p.add_argument("--output", default="sweeps_out", help="[default: sweeps_out]")
    p.add_argument("--yes", action="store_true", help="skip confirmation")
    p.set_defaults(fn=vmapped)

    p = modes.add_parser("bayes", help="Bayesian optimisation over the sweep spec")
    p.add_argument("--output", default="sweeps_out", help="[default: sweeps_out]")
    p.add_argument("--budget", type=int, default=10, help="number of configurations to evaluate  [default: 10]")
    p.add_argument("--metric", default="mean_episode_returns", help="[default: mean_episode_returns]")
    p.add_argument("--tail", type=int, default=5, help="final results.csv rows averaged into the objective  [default: 5]")
    p.add_argument("--bo-seed", type=int, default=0, help="[default: 0]")
    p.add_argument("--yes", action="store_true", help="skip confirmation")
    p.set_defaults(fn=bayes)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    with open(args.config) as f:
        spec = load_spec(f)
    combos = seed_and_shuffle(gen_combos(spec), args.shuffle, args.seeds)
    if not combos:
        print("No valid combinations. Aborted!")
        raise SystemExit(1)
    args.fn(combos, args)


if __name__ == "__main__":
    main()
