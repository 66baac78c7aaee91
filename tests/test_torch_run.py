"""A tiny end-to-end training run of the port on the CPU (`device=cpu`),
recurrent IDQN on LBF, against the JAX package's run of the same config:
both write results.csv with the same header."""

import csv
import math

import pytest
import torch

from codebase_tpu import run as jax_run
from codebase_tpu_torch import run

torch.set_num_threads(2)
ARGV = [
    "+algorithm=idqn",
    "env.name=lbforaging:Foraging-5x5-2p-1f-v3",
    "env.time_limit=5",
    "env.parallel_envs=4",
    "algorithm.total_steps=2000",
    "algorithm.training_start=0",
    "algorithm.batch_size=2",
    "algorithm.buffer_size=16",
    "algorithm.eval_interval=500",
    "algorithm.log_interval=500",
    "algorithm.eval_episodes=8",
    "algorithm.model.use_rnn=true",
    "seed=1",
]


def _header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def test_cpu_run_writes_results_with_the_jax_schema(tmp_path):
    rows, state = run.main(ARGV + ["device=cpu", f"run_dir={tmp_path / 'port'}"])
    jax_run.main(ARGV + [f"run_dir={tmp_path / 'jax'}"])
    header = _header(tmp_path / "port" / "results.csv")
    assert header == _header(tmp_path / "jax" / "results.csv")
    assert len(rows) >= 2 and all(math.isfinite(float(r["loss"])) for r in rows)
    assert state.updates > 0 and state.env_steps >= 2000
    assert (tmp_path / "port" / "config.yaml").exists()


def test_entry_point_refuses_what_it_cannot_do(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run.main(ARGV + ["device=cuda", f"run_dir={tmp_path}"])
    with pytest.raises(NotImplementedError, match="VDN/QMIX"):
        run.main(["+algorithm=idqn", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5",
                  "algorithm.name=qmix", "device=cpu", f"run_dir={tmp_path}"])
    with pytest.raises(NotImplementedError, match="RWARE"):
        run.main(["+algorithm=idqn", "env.name=rware:rware-tiny-2ag-v2", "env.time_limit=5",
                  "device=cpu", f"run_dir={tmp_path}"])
