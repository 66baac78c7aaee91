"""rliable-style performance matrices from `results.csv` trees.

The counterpart of the JAX package's `utils/stats.py`, on the standard
library's csv reader (`utils/postprocessing/load_data.read_columns`) in
place of pandas. The matrices feed rliable's aggregate-metric, performance
profile, probability-of-improvement and sample-efficiency plots:

- `make_agg_metrics_intervals` -> {algo: (n_runs, n_envs)} at a fixed step,
- `make_agg_metrics_pxy` -> {"a,b": ((n_runs, n_envs), (n_runs, n_envs))},
- `make_agg_metrics_efficiency` -> {algo: (n_runs, n_envs, n_steps)}.

Folder layout: `folder/algo/<run>/results.csv`, each run one seed of one
config, as the train CLI writes them.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from codebase_tpu_torch.utils.postprocessing.load_data import read_columns


def _load_data_from_subfolder(folder, metric, step=None, step_metric=None):
    """Each run subfolder's series of `metric` (or its value at the row
    where `step_metric` equals `step`)."""
    results = []
    for sub in sorted(os.listdir(folder)):
        path = Path(folder) / sub / "results.csv"
        if not path.exists():
            continue
        data = read_columns(path)
        if step is not None and step_metric is not None:
            rows = [v for v, s in zip(data[metric], data[step_metric]) if s == step]
            if not rows:
                raise ValueError(f"no row with {step_metric}=={step} in {path}")
            results.append([rows[0]])
        else:
            results.append(list(data[metric]))
    return results


def make_agg_metrics_intervals(folders, algos, metric, step=None, step_metric=None):
    """{algo: (n_runs, n_envs)} performance at a fixed step."""
    if step is None or step_metric is None:
        raise ValueError("For interval plots, step and step_metric must be specified")
    results = {}
    for i in range(len(folders)):
        data = _load_data_from_subfolder(os.path.join(folders[i], algos[i]), metric[i], step[i], step_metric[i])
        results.setdefault(algos[i], []).append(data)
    return {algo: np.array(v).T[0] for algo, v in results.items()}


def make_agg_metrics_pxy(folders, algos, metric, step=None, step_metric=None):
    """Pairwise matrices for probability-of-improvement plots."""
    agg = make_agg_metrics_intervals(folders, algos, metric, step, step_metric)
    out = {}
    for i in range(len(algos)):
        for j in range(len(algos)):
            if i != j:
                out[f"{algos[i]},{algos[j]}"] = (agg[algos[i]], agg[algos[j]])
    return out


def make_agg_metrics_efficiency(folders, algos, metric):
    """{algo: (n_runs, n_envs, n_steps)} sample-efficiency matrices."""
    results = {}
    for i in range(len(folders)):
        data = _load_data_from_subfolder(os.path.join(folders[i], algos[i]), metric[i])
        results.setdefault(algos[i], []).append(data)
    out = {}
    for algo, pulled in results.items():
        n_steps = min(len(r) for env_runs in pulled for r in env_runs)
        arr = np.array([[run[:n_steps] for run in env_runs] for env_runs in pulled])  # (n_envs, n_runs, n_steps)
        out[algo] = arr.transpose(1, 0, 2)
    return out
