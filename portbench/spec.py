"""The benchmark's data, found by name.

- `BENCHMARK.json` at the root of the checkout: the cells and the metrics;
- `portbench/workloads/<cell>.json`: a cell's configuration, traffic
  parameters, chips and why;
- `portbench/configs/<config>.json`: a configuration's train-loop family
  (`family`: `dqn` or `ac`, the module `portbench/families/<family>.py`
  that builds its train state, taps and judges it, and holds its per-layer
  arithmetic), preset, overrides, source, assumed sizes, reduced keys, the
  reference's constants and the limits of the numbers that decide
  `correct`;
- `portbench/metrics/<metric>.py`: one metric each, with `NAME`, `UNIT`,
  `LAYER`, `MOVES`, `SOURCE` and `read(ctx)`, which returns the value or
  None when the run holds nothing for it to read.

A new cell, configuration or metric is a new file; nothing here changes.
A configuration of a family the harness has (a further IA2C, MAA2C, IPPO
or MAPPO, VDN or QMIX) is a configuration file and a workload file, with
a reference env under `portbench/reference/` where its env is new.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def workload(name: str, root: Path = ROOT) -> dict:
    data = json.loads((root / "workloads" / f"{name}.json").read_text())
    if data.get("name") != name:
        raise ValueError(f"workloads/{name}.json names the cell {data.get('name')!r}")
    return data


def config(name: str, root: Path = ROOT) -> dict:
    data = json.loads((root / "configs" / f"{name}.json").read_text())
    if data.get("name") != name:
        raise ValueError(f"configs/{name}.json names the configuration {data.get('name')!r}")
    return data


def metric(name: str, root: Path = ROOT):
    """The module of `metrics/<name>.py`, loaded from its file."""
    path = root / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    if module.NAME != name:
        raise ValueError(f"metrics/{name}.py names the metric {module.NAME!r}")
    return module


def run_metrics(bench: dict, trace: bool) -> list:
    """The names of the metrics a run reads: the end-to-end metrics
    untraced, the per-layer metrics traced. A metric whose `read` finds
    nothing in a cell's run is left out of its line there."""
    return [m["name"] for m in bench["per_layer" if trace else "end_to_end"]]
