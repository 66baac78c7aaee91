"""Loggers: the results.csv filesystem logger, wandb and a console logger.

The `results.csv` schema is the JAX package's (and the reference's):
`environment_steps` first, remaining keys sorted; header written once, rows
appended. `squash_info` takes the per-key mean/std over episode infos,
summing per-agent arrays first; singleton keys pass through unprefixed.
"""

from __future__ import annotations

import csv
import logging
import math
import time
from datetime import timedelta
from pathlib import Path
from typing import Dict, List

import numpy as np

log = logging.getLogger("codebase_tpu_torch")


def episode_infos(out) -> list:
    """Per-episode info dicts shaped like the reference's episode infos, from
    `episode_returns` (E, N) and `episode_lengths` (E,) tensors."""
    returns = out["episode_returns"].cpu().numpy()
    lengths = out["episode_lengths"].cpu().numpy()
    infos = []
    for e in range(returns.shape[0]):
        info = {"episode_returns": returns[e], "episode_length": float(lengths[e])}
        for i in range(returns.shape[1]):
            info[f"agent{i}/episode_returns"] = float(returns[e, i])
        infos.append(info)
    return infos


def squash_info(info: List[Dict]) -> Dict[str, float]:
    new_info = {}
    keys = {k for i in info for k in i.keys()}
    keys.discard("TimeLimit.truncated")
    keys.discard("terminal_observation")
    for key in keys:
        values = [d[key] for d in info if key in d]
        if len(values) == 1:
            v = values[0]
            new_info[key] = float(np.asarray(v).sum()) if np.ndim(v) else v
            continue
        sums = [np.asarray(v).sum() for v in values]
        mean, std = float(np.mean(sums)), float(np.std(sums))
        split_key = key.rsplit("/", 1)
        mean_key, std_key = split_key[:], split_key[:]
        mean_key[-1] = "mean_" + mean_key[-1]
        std_key[-1] = "std_" + std_key[-1]
        new_info["/".join(mean_key)] = mean
        new_info["/".join(std_key)] = std
    return new_info


class Logger:
    """Console logger with UPS/FPS/ETA progress."""

    def __init__(self, project_name: str, cfg, run_dir: Path | str = "."):
        self.project_name = project_name
        self.cfg = cfg
        self.run_dir = Path(run_dir)
        self.config_hash = cfg.hash() if hasattr(cfg, "hash") else ""
        self._total_steps = int(cfg.algorithm.total_steps)
        self._start_time = time.time()
        self._prev_time = None
        self._prev_steps = (0, 0)

    def log_metrics(self, metrics: List[Dict]):
        pass

    def print_progress(self, updates, steps, mean_returns, episodes):
        self.info(f"Updates {updates}, Environment timesteps {steps}")
        time_now = time.time()
        elapsed = time_now - self._prev_time if self._prev_time else None
        elapsed_from_start = timedelta(seconds=math.ceil(time_now - self._start_time))
        completed = steps / self._total_steps if self._total_steps else 0.0
        if elapsed:
            ups = (updates - self._prev_steps[0]) / elapsed
            fps = (steps - self._prev_steps[1]) / elapsed
            self.info(f"UPS: {ups:.2f}, FPS: {fps:.2f} (wall time)")
            if completed > 0:
                eta = elapsed_from_start * (1 - completed) / completed
                self.info(f"Elapsed Time: {elapsed_from_start}")
                self.info(f"Estim. Time Left: {timedelta(seconds=math.ceil(eta.total_seconds()))}")
        self.info(f"Completed: {100 * completed:.2f}%")
        self._prev_steps = (updates, steps)
        self._prev_time = time.time()
        self.info(f"Last {episodes} episodes with mean returns: {mean_returns:.3f}")
        self.info("-------------------------------------------")

    def watch(self, model):
        self.debug(repr(model))

    def debug(self, *a, **k):
        log.debug(*a, **k)

    def info(self, *a, **k):
        log.info(*a, **k)

    def warning(self, *a, **k):
        log.warning(*a, **k)

    def error(self, *a, **k):
        log.error(*a, **k)

    def get_state(self):
        return None


class FileSystemLogger(Logger):
    """Appends squashed metric rows to results.csv and saves config.yaml."""

    def __init__(self, project_name, cfg, run_dir="."):
        super().__init__(project_name, cfg, run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.results_path = self.run_dir / "results.csv"
        self._columns: List[str] | None = None
        (self.run_dir / "config.yaml").write_text(
            cfg.to_yaml() if hasattr(cfg, "to_yaml") else str(cfg)
        )

    def log_metrics(self, metrics: List[Dict]):
        d = squash_info(metrics)
        self._columns = append_results_row(self.results_path, d, self._columns)
        self.print_progress(
            d.get("updates", 0),
            d.get("environment_steps", 0),
            d.get("mean_episode_returns", float("nan")),
            len(metrics) - 1,
        )

    def get_state(self):
        """results.csv as a list of row dicts (strings), or None before the
        first row."""
        if not self.results_path.exists():
            return None
        with open(self.results_path, newline="") as f:
            return list(csv.DictReader(f))


def append_results_row(path: Path, d: Dict, columns: List[str] | None = None) -> List[str]:
    """Append the squashed row `d` to the results.csv at `path`: the header
    (`environment_steps` first, the other keys sorted) when the file is new
    or empty; a row with keys the header lacks widens the file to the union
    of the columns (rows may carry different column sets when log_interval
    and eval_interval diverge). `columns` is the file's header when the
    caller knows it; returns the header after this row."""
    cols = ["environment_steps"] + sorted(k for k in d if k != "environment_steps")
    fresh = not path.exists() or path.stat().st_size == 0
    if fresh:
        columns = cols
        with open(path, "w") as f:
            f.write(",".join(cols) + "\n")
    else:
        if columns is None:  # appending to a pre-existing file
            with open(path) as f:
                columns = f.readline().strip().split(",")
        if any(c not in columns for c in cols):
            columns = ["environment_steps"] + sorted(set(columns + cols) - {"environment_steps"})
            with open(path, newline="") as f:
                rows = list(csv.DictReader(f))
            with open(path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=columns, lineterminator="\n")
                w.writeheader()
                w.writerows(rows)
    with open(path, "a") as f:
        f.write(",".join(_fmt(d.get(c)) for c in columns) + "\n")
    return columns


def _fmt(v) -> str:
    if v is None:
        return ""
    if isinstance(v, float):
        return repr(v)
    return str(v)


class WandbLogger(Logger):
    """Weights & Biases logger, as the JAX package's: one run a config
    (`project_name`, the whole config, grouped by the config's hash without
    the seed), one `log` a squashed row. Needs the optional `wandb` package,
    imported when the logger is made (ImportError without it)."""

    def __init__(self, project_name, cfg, run_dir="."):
        import wandb

        super().__init__(project_name, cfg, run_dir)
        self._run = wandb.init(
            project=project_name,
            config=cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg),
            group=self.config_hash,
        )

    def log_metrics(self, metrics: List[Dict]):
        d = squash_info(metrics)
        self._run.log(d)
        self.print_progress(
            d.get("updates", 0),
            d.get("environment_steps", 0),
            d.get("mean_episode_returns", float("nan")),
            len(metrics) - 1,
        )


LOGGERS = {"filesystem": FileSystemLogger, "basic": Logger, "wandb": WandbLogger}


def make_logger(cfg, run_dir=".") -> Logger:
    name = cfg.get("logger", "filesystem")
    if name not in LOGGERS:
        raise ValueError(f"unknown logger {name!r}; choose from {sorted(LOGGERS)}")
    return LOGGERS[name](cfg.get("project_name", "codebase_tpu_torch"), cfg, run_dir)
