"""On the card: a cell at a test's size through the GRU kernels is
correct, and the reference in TF32 in the program's place is not. Skips
without a card (run on the card with `python3 -m pytest portbench/tests -m
cuda`)."""

import pytest
import torch

from portbench import check, run, spec
from portbench.tests.tiny import tiny_workload


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's GRU kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["idqn_rnn_lbf.collect", "idqn_rnn_lbf.replay32", "mappo_rnn_lbf.collect"])
def test_card_run_is_correct(cell):
    need_card()
    result, lines = run.run_cell(cell, 2**33 + 21, 0.5, True, "cuda", workload=tiny_workload(cell))
    assert result["correct"], lines
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert {"mfu", "gru_kernels_roofline", "updates_device_ms"} <= set(result["metrics"])


@pytest.mark.cuda
def test_card_control_fails():
    need_card()
    workload = tiny_workload()
    config = spec.config(workload["config"])
    cell = run.Cell(workload, config, 2**33 + 22, "cuda")
    cell.free()
    correct, checks = check.verdict(cell.judge("control"), config["limits"])
    assert not correct, checks


@pytest.mark.cuda
def test_card_ac_control_and_fault_fail():
    """The MAPPO cell at a test's size: the reference in TF32, and the
    reference over half the envs, in the program's place are not correct."""
    need_card()
    workload = tiny_workload("mappo_rnn_lbf.collect")
    config = spec.config(workload["config"])
    cell = run.Cell(workload, config, 2**33 + 23, "cuda")
    cell.free()
    for mode in ("control", "half_batch"):
        correct, checks = check.verdict(cell.judge(mode), config["limits"])
        assert not correct, (mode, checks)
