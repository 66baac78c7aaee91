"""Tiny end-to-end training runs of the port on the CPU (`device=cpu`),
recurrent IDQN, recurrent QMIX with reward standardisation and the four
actor-critic presets on LBF, against the JAX package's runs of the same
configs: both write results.csv with the same header."""

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
    with pytest.raises(NotImplementedError, match="bfloat16"):
        run.main(["+algorithm=ia2c", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5",
                  "algorithm.model.actor.dtype=bfloat16", "device=cpu", f"run_dir={tmp_path}"])
    with pytest.raises(ValueError, match="unknown algorithm 'nosuch'"):
        run.main(["+algorithm=nosuch", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5",
                  "device=cpu", f"run_dir={tmp_path}"])
    with pytest.raises(NotImplementedError, match="RWARE"):
        run.main(["+algorithm=idqn", "env.name=rware:rware-tiny-2ag-v2", "env.time_limit=5",
                  "device=cpu", f"run_dir={tmp_path}"])


def test_cpu_qmix_run_with_standardisation_writes_the_jax_schema(tmp_path):
    """The QMIX preset as it is (CooperativeReward above the reward
    standardiser) with reward standardisation on: the run trains with finite
    losses, its reward streams advance, and results.csv has the JAX run's
    header. (Return standardisation is held to the JAX loss in
    test_torch_dqn.py; from a fresh target net it diverges in both packages,
    see test_mixed_return_standardisation_diverges_from_init_in_both_packages.)"""
    argv = ["+algorithm=qmix", "env.standardise_rewards=true", "algorithm.model.parameter_sharing=true"] + ARGV[1:]
    rows, state = run.main(argv + ["device=cpu", f"run_dir={tmp_path / 'port'}"])
    jax_run.main(argv + [f"run_dir={tmp_path / 'jax'}"])
    assert _header(tmp_path / "port" / "results.csv") == _header(tmp_path / "jax" / "results.csv")
    assert len(rows) >= 2 and all(math.isfinite(float(r["loss"])) for r in rows)
    assert state.model.mixer is not None and state.updates > 0
    assert float(state.reward_stream.n.min()) > 0


AC_ARGV = [
    "env.name=lbforaging:Foraging-5x5-2p-1f-v3",
    "env.time_limit=5",
    "env.parallel_envs=4",
    "algorithm.total_steps=100",
    "algorithm.log_interval=40",
    "seed=1",
]


@pytest.mark.parametrize("algo,rnn", [("ia2c", False), ("maa2c", False), ("ippo", False), ("mappo", True)])
def test_cpu_ac_runs_write_the_jax_schema(tmp_path, algo, rnn):
    """Each actor-critic preset trains on the CPU with finite losses and
    writes the JAX run's results.csv header; MAPPO with a recurrent actor
    and a recurrent centralised critic."""
    argv = [f"+algorithm={algo}"] + AC_ARGV
    if rnn:
        argv += ["algorithm.model.actor.use_rnn=true", "algorithm.model.critic.use_rnn=true"]
    rows, state = run.main(argv + ["device=cpu", f"run_dir={tmp_path / 'port'}"])
    jax_run.main(argv + [f"run_dir={tmp_path / 'jax'}"])
    assert _header(tmp_path / "port" / "results.csv") == _header(tmp_path / "jax" / "results.csv")
    assert rows and all(math.isfinite(float(r[k])) for r in rows for k in ("loss", "value_loss", "entropy"))
    # one update per iteration; each iteration steps every env for the longest episode
    assert state.updates == len(state.timings) and state.env_steps >= 100
    assert state.model.actor.use_rnn == state.model.critic.use_rnn == rnn
