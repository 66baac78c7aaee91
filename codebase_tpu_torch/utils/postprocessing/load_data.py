"""Run and Group data model over `results.csv` trees.

The counterpart of the JAX package's `utils/postprocessing/load_data.py`:
loads every `results.csv` under a directory (with the `config.yaml` beside
it), groups runs whose configs are equal but for the seed, and names each
group by the hyperparameters that differ across the loaded runs. The port
writes the JAX package's `results.csv` schema, so it reads both packages'
runs (and the reference's).

It reads the csv with the standard library, as pandas does: an empty cell
is NaN, a column of integers holds ints, a numeric column with a float or
an empty cell holds floats, and any other column strings.
"""

from __future__ import annotations

import csv
import math
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Union

import numpy as np
import yaml


def _number(cell: str):
    try:
        return int(cell)
    except ValueError:
        return float(cell)


def read_columns(path) -> Dict[str, list]:
    """A csv file as {column: values}, typed per column as pandas'
    `read_csv(...).to_dict(orient="list")` types it."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    columns = {}
    for i, name in enumerate(header):
        cells = [row[i] if i < len(row) else "" for row in rows]
        try:
            values = [math.nan if c == "" else _number(c) for c in cells]
        except ValueError:  # a column of strings
            columns[name] = [math.nan if c == "" else c for c in cells]
            continue
        if any(isinstance(v, float) for v in values):
            values = [float(v) for v in values]
        columns[name] = values
    return columns


class Run:
    def __init__(self, config: dict, data: Dict[str, List[float]], path: Path):
        self.config = config
        self.data = data
        self.path = path

    @staticmethod
    def from_path(path: Path) -> "Run":
        path = Path(path)
        if not path.is_dir():
            raise ValueError(f"{path} is not a valid run directory")
        data = read_columns(path / "results.csv")
        config = yaml.safe_load((path / "config.yaml").read_text())
        return Run(config, data, path)

    def __str__(self):
        return f"Run {self.path}"

    def get_config_name(self) -> str:
        return " ".join(f"{k}={v}" for k, v in sorted(flatten_config(self.config).items()) if k != "seed")


class Group:
    def __init__(self, name: str, runs: List[Run]):
        self.name = name
        self.config = dict(runs[0].config)
        self.config.pop("seed", None)
        self.runs = runs

    def __str__(self):
        return f"Group {self.name} ({len(self.runs)} runs)"

    @property
    def env_name(self) -> str:
        return self.config.get("env", {}).get("name", "?")

    def has_metric(self, key: str) -> bool:
        have = [key in run.data for run in self.runs]
        if any(have) and not all(have):
            raise ValueError(f"Key {key} is present in some but not all runs")
        return have[0]

    def get_metric(self, key: str) -> np.ndarray:
        """(runs, points): each run's column, cut to the shortest run's."""
        if not self.has_metric(key):
            raise ValueError(f"Key {key} is not present in all runs")
        values = [run.data[key] for run in self.runs]
        n = min(len(v) for v in values)
        return np.array([v[:n] for v in values])


def flatten_config(config: dict, base: str | None = None) -> Dict[str, Union[str, float, int]]:
    flat = {}
    for key, value in config.items():
        name = f"{base}.{key}" if base else str(key)
        if isinstance(value, dict):
            flat.update(flatten_config(value, name))
        else:
            flat[name] = tuple(value) if isinstance(value, list) else value
    return flat


def load_runs(path: Path) -> List[Run]:
    path = Path(path)
    if not path.is_dir():
        raise ValueError(f"{path} is not a valid directory")
    return [Run.from_path(p.parent) for p in sorted(path.glob("**/results.csv"))]


IGNORED_KEYS = ("seed", "algorithm.name", "hypergroup", "run_dir")


def load_and_group_runs(path: Path, minimal_name: bool = True) -> List[Group]:
    """Group runs by their configs without the seed; with `minimal_name`,
    name each group by the algorithm and the hyperparameters that vary
    across the loaded runs."""
    by_name = defaultdict(list)
    for run in load_runs(path):
        by_name[run.get_config_name()].append(run)

    if minimal_name:
        values_by_key = defaultdict(set)
        for runs in by_name.values():
            for key, value in flatten_config(runs[0].config).items():
                if key in IGNORED_KEYS or "wrappers" in key:
                    continue
                values_by_key[key].add(value)
        distinguishing = [k for k, vals in values_by_key.items() if len(vals) > 1]

        renamed = {}
        for runs in by_name.values():
            flat = flatten_config(runs[0].config)
            name = str(flat.get("algorithm.name", "run")).upper()
            detail = " ".join(f"{k}={flat[k]}" for k in distinguishing if k in flat)
            if detail:
                name += f" ({detail})"
            renamed.setdefault(name, []).extend(runs)
        by_name = renamed

    return [Group(name, runs) for name, runs in by_name.items()]
