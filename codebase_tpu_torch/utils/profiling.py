"""Profiling tools: traces, operation counts, device memory and synced timing.

The counterpart of the JAX package's `utils/profiling.py`:

- `trace(log_dir)`        — a `torch.profiler` trace (CPU and CUDA) of a
  region, written as a Chrome/Perfetto JSON file into `log_dir`
  (`tensorboard_trace_handler`; a data-parallel rank's file names its rank);
  it yields the profiler, whose events `profile.py` reads.
- `annotate(name)`        — a named range inside an active trace
  (`record_function`).
- `count_operations()`   — the operations and bytes of a region: what
  `torch.utils.flop_counter.FlopCounterMode` counts of PyTorch's ops, plus
  the GRU kernels' operations, which the wrappers report from their shapes
  (`ops/fused_gru.kernel_flops`): FlopCounterMode cannot see a `ctypes`
  launch; and the bytes of every dispatched op's tensor inputs and outputs
  (views and ops that move no data count none) plus the GRU kernels'
  (`ops/fused_gru.kernel_bytes`), the counterpart of XLA's "bytes
  accessed". `cost_analysis(fn, *a)` returns the counts of one call.
- `device_memory_stats()` — `torch.cuda.memory_stats` of each visible GPU
  (`{}` on a machine without one).
- `StepTimer`             — steps/s between marks, each mark after a device
  sync.
- `time_windows(step, device, windows, window_iters, counters)` — windows
  of train iterations, each ending in a device sync, with the steps and
  updates each made (`profile.py` and `bench_suite.py` time with it).

XLA's analysis of a compiled program's memory has no counterpart in an
eager program; the port reports the peak device memory of a run instead
(`torch.cuda.max_memory_allocated`, in `profile.py`).

`python -m codebase_tpu_torch.profile` composes these into a report.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, record_function
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

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


# ops whose outputs hold no data they read or wrote: allocations (views are
# told apart by `OpOverload.is_view`)
_NO_DATA = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
            torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided, torch.ops.aten.lift_fresh}


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every dispatched op's tensor inputs and outputs
    (each tensor argument counted as read, each result as written; an
    in-place op's tensor both), skipping views and allocations. The count is
    of bytes addressed: the L2 serves some of them, so bytes over time is an
    estimate of the HBM rate, not a reading of it. The autograd engine runs
    a CUDA backward on a thread of its own, which inherits the mode, so the
    sum takes a lock."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self._lock = threading.Lock()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func.overloadpacket not in _NO_DATA:
            nbytes = sum(t.numel() * t.element_size() for t in tree_leaves((args, kwargs, out))
                         if isinstance(t, torch.Tensor))
            with self._lock:
                self.bytes += nbytes
        return out


def _bmm_flops(a_shape, b_shape, *_, out_shape=None, **kwargs) -> int:
    """2*b*m*n*k of a batched product, also for `bmm.dtype` (bf16 inputs
    and an f32 result, `ops/matmul.py` on the card), whose `out_dtype`
    argument `FlopCounterMode`'s own formula takes for its `out_shape`."""
    b, m, k = a_shape
    return 2 * b * m * b_shape[-1] * k


@contextlib.contextmanager
def count_operations():
    """Count the operations and bytes of the enclosed region; yields a dict
    whose `flops` (PyTorch's ops as `FlopCounterMode` counts them: matrix
    products, convolutions, attention; plus the GRU kernels' operations),
    `gru_kernel_flops` (those alone), `bytes` (`_ByteCounter`'s, plus the GRU
    kernels' bytes) and `gru_kernel_bytes` (those alone) are filled in on
    exit."""
    from torch.utils.flop_counter import FlopCounterMode

    result = {"flops": 0.0, "gru_kernel_flops": 0.0, "bytes": 0.0, "gru_kernel_bytes": 0.0}
    bytes_mode = _ByteCounter()
    kernels = {"flops": 0.0, "bytes": 0.0}
    lock = threading.Lock()  # the backward's launches come from the autograd engine's thread

    def count(kernel, outputs, dims):
        with lock:
            kernels["flops"] += fused_gru.kernel_flops(kernel, dims)
            kernels["bytes"] += fused_gru.kernel_bytes(kernel, dims)

    fused_gru.LAUNCH_OBSERVERS.append(count)
    try:
        with FlopCounterMode(display=False, custom_mapping={torch.ops.aten.bmm: _bmm_flops}) as counter, \
                bytes_mode:
            yield result
    finally:
        fused_gru.LAUNCH_OBSERVERS.remove(count)
    result["gru_kernel_flops"], result["gru_kernel_bytes"] = kernels["flops"], kernels["bytes"]
    result["flops"] = float(counter.get_total_flops()) + kernels["flops"]
    result["bytes"] = float(bytes_mode.bytes) + kernels["bytes"]


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


def time_windows(step: Callable[[], Any], device, windows: int, window_iters: int,
                 counters: Callable[[], Tuple[int, int]]) -> List[Dict[str, float]]:
    """Time `windows` windows of `window_iters` calls of `step()` (one train
    iteration a call). Each window starts after a device sync and ends in
    one, on the host clock; `counters()` (the state's env steps and updates)
    is read outside the timed region. Returns each window's `steps`,
    `updates` and `seconds`."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = []
    steps0, updates0 = counters()
    for _ in range(windows):
        sync()
        t0 = time.perf_counter()
        for _ in range(window_iters):
            step()
        sync()
        seconds = time.perf_counter() - t0
        steps, updates = counters()
        out.append({"steps": steps - steps0, "updates": updates - updates0, "seconds": seconds})
        steps0, updates0 = steps, updates
    return out
