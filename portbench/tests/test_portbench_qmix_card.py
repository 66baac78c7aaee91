"""On the card: the MMM2 QMIX cell at a test's size, traced, is correct and
reads `linear_dw_roofline` (the mixer's and the critic's weight gradients
on the kernels), and the reference in TF32 in the program's place is not
correct. Skips without a card (run on the card with `python3 -m pytest
portbench/tests -m cuda`)."""

import pytest
import torch

from portbench import check, run, spec
from portbench.tests.tiny import tiny_workload
from codebase_tpu_torch.utils import profiling

CELL = "qmix_rnn_mmm2.replay32"


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's GRU kernels have no CPU mode")


@pytest.mark.cuda
def test_qmix_card_run_is_correct_and_reads_the_weight_gradient_roofline():
    need_card()
    profiling.reset_counters()  # the metric reads the counters since the start: this run's alone
    result, lines = run.run_cell(CELL, 2**33 + 31, 0.5, True, "cuda", workload=tiny_workload(CELL))
    assert result["correct"], lines
    assert {"linear_dw_roofline", "gru_kernels_roofline", "host_syncs_per_iter", "updates_device_ms"} <= set(
        result["metrics"])
    assert 0 < result["metrics"]["linear_dw_roofline"]["value"] <= 100
    calls = {k[2]: n for k, n in profiling.counters().items() if isinstance(k, tuple) and k[0] == "linear/dw"}
    K = 101 * tiny_workload(CELL)["traffic"]["batch_size"]
    assert {(1, K - 32, 1660, 192), (10, K, 166, 128)} <= set(calls)  # the mixer's T B rows, the critic's (T+1) B
    assert not [k for k in profiling.counters() if isinstance(k, tuple) and k[:2] == ("linear/dw", "cublas")]


@pytest.mark.cuda
def test_qmix_card_control_fails():
    need_card()
    workload = tiny_workload(CELL)
    config = spec.config(workload["config"])
    cell = run.Cell(workload, config, 2**33 + 32, "cuda")
    cell.free()
    correct, checks = check.verdict(check.judge(cell.taps, cell.w0, config["reference"], cell.device,
                                                "control"), config["limits"])
    assert not correct, checks
