"""Profiling tools: traces, operation counts, device memory and synced timing.

The counterpart of the JAX package's `utils/profiling.py`:

- `trace(log_dir)`        — a `torch.profiler` trace (CPU and CUDA) of a
  region, written as a Chrome/Perfetto JSON file into `log_dir`
  (`tensorboard_trace_handler`; a data-parallel rank's file names its rank);
  it yields the profiler, whose events `profile.py` reads.
- `annotate(name)`        — a named range inside an active trace
  (`record_function`).
- `count_operations()`   — the operations of a region: what
  `torch.utils.flop_counter.FlopCounterMode` counts of PyTorch's ops, plus
  the GRU kernels' operations, which the wrappers report from their shapes
  (`ops/fused_gru.kernel_flops`): FlopCounterMode cannot see a `ctypes`
  launch. `cost_analysis(fn, *a)` returns `{"flops": ...}` of one call.
- `device_memory_stats()` — `torch.cuda.memory_stats` of each visible GPU
  (`{}` on a machine without one).
- `StepTimer`             — steps/s between marks, each mark after a device
  sync.

XLA's analysis of a compiled program's memory has no counterpart in an
eager program; the port reports the peak device memory of a run instead
(`torch.cuda.max_memory_allocated`, in `profile.py`).

`python -m codebase_tpu_torch.profile` composes these into a report.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from torch.profiler import ProfilerActivity, record_function

from codebase_tpu_torch.ops import fused_gru


@contextlib.contextmanager
def trace(log_dir=None):
    """Trace the enclosed region (host ops and ranges, and the GPU's kernels
    when CUDA is available); yields the `torch.profiler.profile`. With a
    `log_dir`, the trace is written there as `<worker>.<time>.pt.trace.json`,
    the worker `rank<r>` in a data-parallel run, else the host and process
    id."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handler = None
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else None
        handler = torch.profiler.tensorboard_trace_handler(
            str(log_dir), worker_name=None if rank is None else f"rank{rank}")
    with torch.profiler.profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof


def annotate(name: str):
    """A named range inside an active trace."""
    return record_function(name)


@contextlib.contextmanager
def count_operations():
    """Count the operations of the enclosed region; yields a dict whose
    `flops` (PyTorch's ops as `FlopCounterMode` counts them: matrix
    products, convolutions, attention; plus the GRU kernels' operations)
    and `gru_kernel_flops` (those alone) are filled in on exit."""
    from torch.utils.flop_counter import FlopCounterMode

    result = {"flops": 0.0, "gru_kernel_flops": 0.0}

    def count(kernel, outputs, dims):
        result["gru_kernel_flops"] += fused_gru.kernel_flops(kernel, dims)

    fused_gru.LAUNCH_OBSERVERS.append(count)
    try:
        with FlopCounterMode(display=False) as counter:
            yield result
    finally:
        fused_gru.LAUNCH_OBSERVERS.remove(count)
    result["flops"] = float(counter.get_total_flops()) + result["gru_kernel_flops"]


def cost_analysis(fn, *args, **kwargs) -> Dict[str, float]:
    """Run `fn(*args, **kwargs)` once and return `count_operations`' counts
    of the call."""
    with count_operations() as result:
        fn(*args, **kwargs)
    return result


def device_memory_stats() -> Dict[str, Dict[str, Any]]:
    """Per-GPU memory statistics (`torch.cuda.memory_stats`, with
    `bytes_in_use` and `peak_bytes_in_use` from its allocated bytes, and
    `bytes_limit` the card's memory); `{}` without a GPU."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = dict(torch.cuda.memory_stats(i))
        s["bytes_in_use"] = s.get("allocated_bytes.all.current", 0)
        s["peak_bytes_in_use"] = s.get("allocated_bytes.all.peak", 0)
        s["bytes_limit"] = torch.cuda.get_device_properties(i).total_memory
        stats[f"cuda:{i}"] = s
    return stats


class StepTimer:
    """Steps/s between marks, with a device sync at each mark.

        timer = StepTimer(device)
        timer.mark(state.env_steps)
        ... train iterations ...
        timer.mark(state.env_steps)
        timer.rate()  # env-steps/s since the previous mark
    """

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self._last: Optional[tuple] = None
        self._rate: Optional[float] = None

    def mark(self, steps: int) -> Optional[float]:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._last is not None:
            prev_steps, prev_t = self._last
            dt = now - prev_t
            if dt > 0 and steps > prev_steps:
                self._rate = (steps - prev_steps) / dt
        self._last = (int(steps), now)
        return self._rate

    def rate(self) -> Optional[float]:
        return self._rate
