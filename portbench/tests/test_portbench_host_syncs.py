"""`host_syncs_per_iter` reads the program's sync counters over its
iteration counter, and nothing from a program without the registry."""

import pytest

from portbench import spec
from codebase_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def test_syncs_over_iterations():
    metric = spec.metric("host_syncs_per_iter")
    assert metric.read({}) is None  # no iteration counted
    profiling.count("dqn/iterations", 4)
    assert metric.read({}) == 0.0
    profiling.count("sync/rollout_seed", 4)
    profiling.count("sync/replay_filled", 4)
    profiling.count("sync/early_exit", 2)
    profiling.count("rollout/policy_steps", 100)
    profiling.count(("gru/forward", (2, 1, 64, 128)), 100)
    assert metric.read({}) == 10 / 4


def test_a_program_without_the_registry_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "counters")
    assert spec.metric("host_syncs_per_iter").read({}) is None


def test_the_metric_is_declared_for_both_cells():
    (entry,) = [m for m in spec.benchmark()["per_layer"] if m["name"] == "host_syncs_per_iter"]
    metric = spec.metric("host_syncs_per_iter")
    assert (entry["unit"], entry["layer"], entry["moves"], entry["source"]) == (
        metric.UNIT, metric.LAYER, metric.MOVES, metric.SOURCE)
    assert entry["workloads"] == [w["name"] for w in spec.benchmark()["workloads"]]
