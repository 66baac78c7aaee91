"""The window's rate is all the work over all the time, and the trace
reduction counts what the device did."""

import time
from types import SimpleNamespace

import torch
from torch.autograd import DeviceType

from portbench import run, spec, trace
from portbench.families import dqn


class FakeCell:
    """Iterations of uneven length and work: one stall among them."""

    def __init__(self):
        self.device = torch.device("cpu")
        self.steps, self.calls = 0, 0

    def iterate(self):
        self.calls += 1
        time.sleep(0.2 if self.calls == 3 else 0.01)
        self.steps += 100 * self.calls

    def env_steps(self):
        return self.steps


def test_rate_is_whole_window():
    cell = FakeCell()
    w = run.measure(cell, 0.25)
    assert w["iters"] == cell.calls >= 3
    assert w["env_steps"] == sum(100 * k for k in range(1, cell.calls + 1))
    assert w["seconds"] >= 0.2 + 0.01 * (cell.calls - 1)
    rate = spec.metric("env_steps_per_s").read({"window": w})
    assert rate == w["env_steps"] / w["seconds"]  # the stall is in it: no best window


def _event(name, start, end, device, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=device, is_user_annotation=annotation)


def test_trace_summary():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _event("dqn/rollout", 0, 100, cpu), _event("aten::item", 30, 45, cpu),
        _event("dqn/rollout", 5, 60, cuda, True), _event("env/step", 5, 30, cuda, True),
        _event("k1", 10, 20, cuda), _event("k2", 15, 25, cuda), _event("Memset (Device)", 50, 52, cuda),
        _event("dqn/updates", 60, 100, cuda, True), _event("gru_fwd_kernel<1>", 70, 90, cuda),
    ]
    s = trace.summarise(events, 2, (*dqn.RANGES.values(), "env/step"))
    assert s["kernels_per_iter"] == 1.5 and s["ops_per_iter"] == 2.0
    assert s["busy_us"] == 15 + 2 + 20
    assert s["range_us_per_iter"]["dqn/rollout"] == (10 + 10 + 2) / 2
    assert s["range_us_per_iter"]["env/step"] == (10 + 10) / 2
    assert s["range_us_per_iter"]["dqn/updates"] == 20 / 2
    assert s["by_name"]["gru_fwd_kernel<1>"] == (0.5, 10.0)
    gaps = dict(s["idle_gaps"])
    assert gaps == {"dqn/rollout>aten::item": 25e-6, "dqn/rollout>python": 18e-6}
