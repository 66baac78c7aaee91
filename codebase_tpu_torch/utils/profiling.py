"""Profiling tools: traces, operation counts, device memory and synced timing.

The counterpart of the JAX package's `utils/profiling.py`:

- `trace(log_dir)`        — a `torch.profiler` trace (CPU and CUDA) of a
  region, written as a Chrome/Perfetto JSON file into `log_dir`
  (`tensorboard_trace_handler`; a data-parallel rank's file names its rank);
  it yields the profiler, whose events `profile.py` reads.
- `span(name)`            — the program's one span helper, gated: a
  `record_function` range while a profiler is on (so on the device's clock
  too), host time into the open `host_spans()` collector, and else nothing
  but a flag check. `SPANS` declares every name the port opens.
- `host_spans()`          — a collector of each span name's host time while
  open, off by default: calls, inclusive time, self time (less the child
  spans of the same thread) and the time inside `sync/*` spans.
- `count(name, n)`        — the counter registry (`counters()`,
  `reset_counters()`): the GRU kernels' launches (`ops/fused_gru.py`), the
  recurrence's calls by shape, the f32 weight gradients by route and shape
  and their kernels' launches (`ops/grouped_dw.py`), the QMIX mixer's
  calls by shape (`algos/dqn.py`), the rollout's policy steps, its env
  steps by path (`envs/step_graph.py`: graph captures, replays, eager
  steps), the host syncs (`host_sync(name)`, a span that also counts).
- `count_operations()`   — the operations and bytes of a region: what
  `torch.utils.flop_counter.FlopCounterMode` counts of PyTorch's ops, plus
  the hand-written kernels' operations (the GRU kernels' and the f32 weight
  gradient's), which the wrappers report from their shapes
  (`ops/kernel_lib.kernel_flops`): FlopCounterMode cannot see a `ctypes`
  launch; and the bytes of every dispatched op's tensor inputs and outputs
  (views and ops that move no data count none) plus the kernels'
  (`ops/kernel_lib.kernel_bytes`), the counterpart of XLA's "bytes
  accessed". `cost_analysis(fn, *a)` returns the counts of one call.
- `device_memory_stats()` — `torch.cuda.memory_stats` of each visible GPU
  (`{}` on a machine without one).
- `time_windows(step, device, windows, window_iters, counters)` — windows
  of train iterations, each ending in a device sync, with the steps and
  updates each made (`profile.py` and `bench_suite.py` time with it).

XLA's analysis of a compiled program's memory has no counterpart in an
eager program; the port reports the peak device memory of a run instead
(`torch.cuda.max_memory_allocated`, in `profile.py`).

`python -m codebase_tpu_torch.profile` composes these into a report and
reads every span and counter.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, record_function
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from codebase_tpu_torch.ops import kernel_lib

# every span the port opens, each read by `profile.py` (sub-ranges and host
# spans) and named in PERF.md
SPANS = (
    # the train iteration's ranges (`profile.RANGES`)
    "dqn/rollout", "dqn/reward_stream", "dqn/replay_add", "dqn/updates",
    "ac/rollout", "ac/reward_stream", "ac/update",
    # inside them (`profile.SUB_RANGES`)
    "env/step", "dqn/sample", "dqn/optimizer", "gru/forward", "gru/backward", "linear/dw", "qmix/mixer",
    # reads the host waits on the device for (`host_sync`), each also counted
    "sync/rollout_seed", "sync/early_exit", "sync/replay_filled", "sync/loss",
)


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


_OFF = contextlib.nullcontext()
_host = None  # the open `HostSpans`, if any
_counters: Dict[Any, int] = {}
_counters_lock = threading.Lock()  # the backward counts from the autograd engine's thread


def span(name: str):
    """A span named `name` (one of `SPANS`) around the enclosed work: a
    `record_function` range while a profiler is on, host time into the open
    `host_spans()` collector, both or neither. With neither it costs this
    check: `record_function` runs its dispatcher op even with no profiler
    listening."""
    profiled = torch.autograd._profiler_enabled()
    if _host is None:
        return record_function(name) if profiled else _OFF
    return _HostSpan(_host, name, record_function(name) if profiled else None)


def host_sync(name: str):
    """A span around a read that makes the host wait on the device (a
    device-to-host read, a blocking copy), also counted under `name`."""
    count(name)
    return span(name)


class HostSpans:
    """Host time of each span name while `host_spans()` is open, on
    `time.perf_counter_ns`: `totals[name] = [calls, ns, self ns, sync ns]`.
    Self time is the span's time less the part its child spans (of the same
    thread: the autograd engine runs a CUDA backward on a thread of its own,
    whose spans are roots there) cover; sync time is the part inside `sync/*`
    spans, a sync span's own time included."""

    def __init__(self):
        self.totals: Dict[str, List[int]] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def add(self, name: str, ns: int, self_ns: int, sync_ns: int) -> None:
        with self._lock:
            t = self.totals.setdefault(name, [0, 0, 0, 0])
            t[0] += 1
            t[1] += ns
            t[2] += self_ns
            t[3] += sync_ns

    def report(self, iters: int = 1) -> Dict[str, Dict[str, float]]:
        """Per name, per iteration: `calls`, `ms`, `self_ms`, `sync_ms`."""
        with self._lock:
            return {name: {"calls": c / iters, "ms": ns / 1e6 / iters, "self_ms": own / 1e6 / iters,
                           "sync_ms": sync / 1e6 / iters}
                    for name, (c, ns, own, sync) in sorted(self.totals.items())}


class _HostSpan:
    __slots__ = ("spans", "name", "range", "start", "child_ns", "sync_ns")

    def __init__(self, spans: HostSpans, name: str, rng):
        self.spans, self.name, self.range = spans, name, rng

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        self.spans.stack().append(self)
        self.child_ns = self.sync_ns = 0
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.start
        stack = self.spans.stack()
        stack.pop()
        sync_ns = ns if self.name.startswith("sync/") else self.sync_ns
        if stack:
            stack[-1].child_ns += ns
            stack[-1].sync_ns += sync_ns
        self.spans.add(self.name, ns, ns - self.child_ns, sync_ns)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


@contextlib.contextmanager
def host_spans():
    """Collect the host time of every span opened inside; yields the
    `HostSpans`. One at a time."""
    global _host
    if _host is not None:
        raise RuntimeError("a host_spans() collector is already open")
    _host = HostSpans()
    try:
        yield _host
    finally:
        _host = None


def count(name, n: int = 1) -> None:
    """Add `n` to the counter `name` (a string, or a tuple for a keyed
    counter such as `("gru/forward", (G, T, B, H))`)."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[Any, int]:
    """A copy of every counter since the last reset."""
    with _counters_lock:
        return dict(_counters)


def reset_counters(names=None) -> None:
    """Zero every counter, or those in `names`."""
    with _counters_lock:
        if names is None:
            _counters.clear()
        for name in names or ():
            _counters.pop(name, None)


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
    products, convolutions, attention; plus the hand-written kernels'
    operations: the GRU kernels' and the f32 weight gradient's),
    `kernel_flops` (those alone), `bytes` (`_ByteCounter`'s, plus the
    kernels' bytes) and `kernel_bytes` (those alone) are filled in on exit."""
    from torch.utils.flop_counter import FlopCounterMode

    result = {"flops": 0.0, "kernel_flops": 0.0, "bytes": 0.0, "kernel_bytes": 0.0}
    bytes_mode = _ByteCounter()
    kernels = {"flops": 0.0, "bytes": 0.0}
    lock = threading.Lock()  # the backward's launches come from the autograd engine's thread

    def count(kernel, outputs, dims):
        with lock:
            kernels["flops"] += kernel_lib.kernel_flops(kernel, dims)
            kernels["bytes"] += kernel_lib.kernel_bytes(kernel, dims)

    kernel_lib.LAUNCH_OBSERVERS.append(count)
    try:
        with FlopCounterMode(display=False, custom_mapping={torch.ops.aten.bmm: _bmm_flops}) as counter, \
                bytes_mode:
            yield result
    finally:
        kernel_lib.LAUNCH_OBSERVERS.remove(count)
    result["kernel_flops"], result["kernel_bytes"] = kernels["flops"], kernels["bytes"]
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
