"""`linear_dw_roofline` reads the program's kernel-routed weight gradients
over its iteration counter against the `grouped_dw` kernels' device time,
checked by hand on a synthetic run; it reads nothing without a trace, peaks
or counters, and its BENCHMARK.json entry matches the module."""

import pytest

from portbench import counts, spec
from portbench.families import dqn
from codebase_tpu_torch.utils import profiling

PEAKS = counts.PEAKS[counts.H100_SXM]
TRACE = {"iters": 3, "by_name": {
    "(anonymous namespace)::grouped_dw_kernel(CUtensorMap_st, CUtensorMap_st, float*, int, int, int, int)": (1.0, 600.0),
    "(anonymous namespace)::grouped_dw_ffma_kernel(float const*, float const*, float*, int)": (2.0, 150.0),
    "(anonymous namespace)::grouped_dw_reduce_kernel(float const*, float*, int, int)": (2.0, 50.0),
    "(anonymous namespace)::gru_dw_kernel(CUtensorMap_st, float*, int)": (1.0, 900.0),
    "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8": (3.0, 7000.0),
}}


def dqn_ctx(trace, peaks):
    """A DQN cell's context: the program's `dqn/iterations` counter as it
    stands."""
    return {"trace": trace, "peaks": peaks, "iterations": dqn.Train.iterations(0)}


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def test_least_time_over_the_kernels_device_time_by_hand():
    metric = spec.metric("linear_dw_roofline")
    profiling.count("dqn/iterations", 2)
    profiling.count(("linear/dw", "kernel", (1, 102_400, 1660, 192)), 2)  # operations bound
    profiling.count(("linear/dw", "kernel", (10, 103_424, 128, 18)), 4)  # bytes bound
    profiling.count(("linear/dw", "cublas", (2, 100, 128, 384)), 2)  # not the kernels': not counted
    profiling.count(("gru/forward", (10, 1, 1024, 128)), 7)
    ops = 3 * 2 * 102_400 * 1660 * 192 / 495e12  # 0.3956 ms, over its bytes' 0.2268 ms
    byt = 4 * 10 * (103_424 * 128 + 103_424 * 18 + 128 * 18) / 3.35e12  # 0.1803 ms, over its operations' 0.0289
    least_per_iter = (2 * ops + 4 * byt) / 2
    device = (600.0 + 150.0 + 50.0) / 1e6  # the grouped_dw kernels and reduction; not gru_dw, not cuBLAS
    assert metric.read(dqn_ctx(TRACE, PEAKS)) == pytest.approx(100 * least_per_iter / device, rel=1e-12)
    assert metric.least_seconds(1, 102_400, 1660, 192, PEAKS) == pytest.approx(ops)
    assert metric.least_seconds(10, 103_424, 128, 18, PEAKS) == pytest.approx(byt)


def test_nothing_to_read_is_none(monkeypatch):
    metric = spec.metric("linear_dw_roofline")
    assert metric.read(dqn_ctx(TRACE, PEAKS)) is None  # no iteration counted
    profiling.count("dqn/iterations", 1)
    assert metric.read(dqn_ctx(TRACE, PEAKS)) is None  # no kernel-routed weight gradient
    profiling.count(("linear/dw", "kernel", (2, 212_992, 128, 384)))
    assert metric.read(dqn_ctx(TRACE, PEAKS)) > 0
    assert metric.read(dqn_ctx(None, PEAKS)) is None  # untraced
    assert metric.read(dqn_ctx(TRACE, None)) is None  # a card without peaks
    assert metric.read(dqn_ctx(dict(TRACE, by_name={"gru_fwd_kernel": (1.0, 5.0)}), PEAKS)) is None
    monkeypatch.delattr(profiling, "counters")  # a program without the registry
    assert metric.read(dqn_ctx(TRACE, PEAKS)) is None


def test_the_metric_is_declared_as_the_module_says():
    (entry,) = [m for m in spec.benchmark()["per_layer"] if m["name"] == "linear_dw_roofline"]
    metric = spec.metric("linear_dw_roofline")
    assert (entry["unit"], entry["layer"], entry["moves"], entry["source"]) == (
        metric.UNIT, metric.LAYER, metric.MOVES, metric.SOURCE)
    assert "workloads" not in entry  # read in every cell: each runs the kernels
