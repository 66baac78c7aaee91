"""Debug mode: located NaN, index and division errors from a train iteration.

The counterpart of the JAX package's `utils/debug.py`, which turns on
`jax_debug_nans` and checkify's float, index and division checks. Here
`debug=true` runs each train iteration under `checks()`, which has four
parts:

- **NaN checks** (`DebugMode`, a `TorchDispatchMode`): every aten op's
  floating outputs are scanned, and a NaN raises `FloatingPointError`
  naming the op, the shapes of its inputs and outputs, and the Python
  source line of the call. Ops that only move, copy or select values
  (views, copies, `index_select`, `cat`, `stack`, ...) are not scanned: a
  NaN in their output came from an input, so the error names the first op
  that computes with it. Factory ops that leave memory undefined (`empty`)
  are not scanned either.
- **Index and division checks**, before the op runs: a gather, index,
  scatter or `take_along_dim` whose indices fall outside the indexed
  dimension raises a located `IndexError` (on a CUDA tensor a device-side
  assert would poison the context, and `take_along_dim` wraps an index
  that is out of range without a word); an integer division or remainder
  by zero raises a located `ZeroDivisionError`.
- **Anomaly mode** (`torch.autograd.set_detect_anomaly(True)`) in the
  backward: a backward node whose output holds a NaN raises naming that
  node (`FusedGRUSequenceBackward` for the GRU kernels), with the
  traceback of the forward call that made it.
- **The GRU kernels**, which launch through `ctypes`, so no PyTorch tool
  sees what they write: while `checks()` is active each wrapper in
  `ops/fused_gru.py` scans its outputs after the launch and raises
  `FloatingPointError` naming the kernel (`gru_fwd_kernel`,
  `gru_bwd_kernel`, ...), the output and G, T, B, H.

The dispatch mode lives in the thread-local state that the autograd engine
hands to its device threads, so it also scans the backward's ops where
the engine runs a CUDA backward on a thread of its own (`chip_smoke.py`'s
`debug_idqn_rnn` counts the ops it scanned there, thousands an
iteration). Anomaly mode is the second guard there.

The NaNs and infinities the port makes on purpose inside an iteration get
the JAX package's treatment:
- the value-based loss logged where no update happened (before
  `training_start`, and a sweep's units that may not train yet) is NaN for
  the logger's nan-mean; under debug it is 0.0 (`algos/dqn.py`), as the JAX
  package swaps its sentinel;
- masked exploration draws (`algos/dqn.py`) and the envs' uniform choices
  (`envs/api.gumbel_argmax`) take the argmax of logits with -inf where an
  action is not allowed, as the JAX package does: an infinity, not a NaN,
  so neither package's checks flag it (a uniform draw of exactly 0 makes an
  infinite Gumbel sample the same way). Masked logits elsewhere are the
  finite -1e8.

Cost: each check reads a value back to the host, so every op waits for the
device; expect several-fold slower iterations. Off by default: it changes
no result, and a run without it pays for no check and no sync.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Iterable

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# ops whose output holds only values of their inputs (or undefined memory):
# not scanned for NaN. View ops are recognised by their schema.
MOVES = {
    aten.clone, aten.copy_, aten.copy, aten._to_copy, aten.contiguous, aten.detach, aten.lift_fresh,
    aten.lift_fresh_copy, aten.alias, aten._unsafe_view, aten.index_select, aten.gather, aten.index,
    aten.index_put, aten.index_put_, aten._index_put_impl_, aten.cat, aten.stack, aten.repeat, aten.flip,
    aten.roll, aten.constant_pad_nd, aten.slice_scatter, aten.select_scatter, aten.scatter, aten.scatter_,
    aten.take, aten.embedding, aten.masked_select, aten.unbind, aten.split, aten.split_with_sizes,
    aten.chunk, aten.narrow, aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.set_, aten.index_copy, aten.index_copy_,
}

# (op, position of the indexed tensor, position of the dim or None, position
# of the index): the index must lie in [0, size) of the indexed dimension
DIM_INDEXED = {
    aten.gather: (0, 1, 2),
    aten.scatter: (0, 1, 2),
    aten.scatter_: (0, 1, 2),
    aten.scatter_add: (0, 1, 2),
    aten.scatter_add_: (0, 1, 2),
    aten.scatter_reduce: (0, 1, 2),
    aten.scatter_reduce_: (0, 1, 2),
    aten.index_select: (0, 1, 2),
    aten.index_add: (0, 1, 2),
    aten.index_add_: (0, 1, 2),
    aten.index_copy: (0, 1, 2),
    aten.index_copy_: (0, 1, 2),
    aten.index_fill: (0, 1, 2),
    aten.index_fill_: (0, 1, 2),
    aten.embedding: (0, None, 1),
    aten.take: (0, None, 1),
}
# advanced indexing (`x[idx]`, `x[idx] = v`): each index tensor may also
# count from the end, [-size, size)
ADVANCED = {aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_}
# integer division and remainder (a float division by zero is inf, or NaN,
# which the NaN check sees)
DIVISIONS = {aten.div, aten.div_, aten.floor_divide, aten.floor_divide_, aten.remainder, aten.remainder_,
             aten.fmod, aten.fmod_}

_HERE = os.path.abspath(__file__)
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))


def source_line() -> str:
    """The innermost Python frame outside PyTorch and this module, as
    `file:line in function`; the autograd engine's threads have none."""
    frame = sys._getframe(1)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if path != _HERE and not path.startswith(_TORCH_DIR) and "contextlib" not in path:
            return f"{path}:{frame.f_lineno} in {frame.f_code.co_name}"
        frame = frame.f_back
    return f"no Python frame (thread {threading.current_thread().name}: the backward)"


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _shapes(x) -> list:
    return [tuple(t.shape) for t in _tensors(x)]


def _arg(args, kwargs, pos, name):
    return args[pos] if len(args) > pos else kwargs.get(name)


def check_index(op: str, index: torch.Tensor, size: int, negative: bool, what: str) -> None:
    """Raise a located IndexError unless every entry of `index` lies in
    [0, size) (or [-size, size) when `negative`)."""
    if index.numel() == 0:
        return
    lo, hi = torch.stack([index.min(), index.max()]).tolist()
    low = -size if negative else 0
    if lo < low or hi >= size:
        raise IndexError(
            f"{op}: index out of range for {what} of size {size}: indices span [{lo}, {hi}], "
            f"allowed [{low}, {size - 1}] (index shape {tuple(index.shape)}) at {source_line()}"
        )


def _check_indices(func, args, kwargs) -> None:
    packet = func.overloadpacket
    if packet in DIM_INDEXED:
        src_pos, dim_pos, idx_pos = DIM_INDEXED[packet]
        src = _arg(args, kwargs, src_pos, "self")
        index = _arg(args, kwargs, idx_pos, "index" if dim_pos is not None else "indices")
        if not isinstance(index, torch.Tensor) or index.is_floating_point():
            return
        if dim_pos is None:
            size, what = (src.shape[0], "dimension 0") if packet is aten.embedding else (src.numel(), "all entries")
        else:
            dim = int(_arg(args, kwargs, dim_pos, "dim")) % max(src.ndim, 1)
            size, what = (src.shape[dim] if src.ndim else 1), f"dimension {dim}"
        check_index(str(func), index, size, False, what)
    elif packet in ADVANCED:
        src, indices = args[0], args[1]
        dim = 0
        for index in indices:
            if index is None:
                dim += 1
            elif index.dtype in (torch.bool, torch.uint8):
                dim += index.ndim
            else:
                check_index(str(func), index, src.shape[dim], True, f"dimension {dim}")
                dim += 1


def _check_division(func, args) -> None:
    if len(args) < 2:
        return
    num, den = args[0], args[1]
    if isinstance(num, torch.Tensor) and num.is_floating_point():
        return
    if isinstance(den, torch.Tensor):
        if den.is_floating_point() or den.is_complex():
            return
        zero = bool((den == 0).any())
    elif isinstance(den, bool) or not isinstance(den, int):
        return
    else:
        zero = den == 0
    # a true division of integers makes floats (x / 0 = inf), as in JAX
    true_div = func.overloadpacket in (aten.div, aten.div_) and func._overloadname in ("Tensor", "Scalar")
    if zero and not true_div:
        raise ZeroDivisionError(f"{func}: integer division or remainder by zero at {source_line()}")


def check_no_nan(what: str, outputs: dict, detail: str = "") -> None:
    """Raise FloatingPointError when one of `outputs` (name -> tensor) holds
    a NaN, naming `what`, the output and `detail`."""
    for name, t in outputs.items():
        if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()) and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"{what} wrote NaN into {name} {tuple(t.shape)}{detail}")


class DebugMode(TorchDispatchMode):
    """The NaN, index and division checks of every aten op (see the module
    docstring). `threads` collects the ids of the threads it saw ops on."""

    def __init__(self):
        super().__init__()
        self.threads = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        tid = threading.get_ident()
        self.threads[tid] = self.threads.get(tid, 0) + 1
        if packet in DIM_INDEXED or packet in ADVANCED:
            _check_indices(func, args, kwargs)
        elif packet in DIVISIONS:
            _check_division(func, args)
        out = func(*args, **kwargs)
        if packet not in MOVES and not func.is_view:
            for i, t in enumerate(_tensors(out)):
                if (t.is_floating_point() or t.is_complex()) and bool(torch.isnan(t).any()):
                    raise FloatingPointError(
                        f"NaN in output {i} {tuple(t.shape)} of {func} (inputs {_shapes(args)}) at {source_line()}"
                    )
        return out


class _TakeAlongDim(TorchFunctionMode):
    """`take_along_dim` is composite: it wraps an out-of-range index before
    the gather that the dispatch mode sees, so its indices are checked here."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.take_along_dim, torch.Tensor.take_along_dim):
            src, index = args[0], _arg(args, kwargs, 1, "indices")
            dim = _arg(args, kwargs, 2, "dim")
            if dim is None:
                check_index("take_along_dim", index, src.numel(), True, "the flattened tensor")
            else:
                dim = int(dim) % src.ndim
                check_index("take_along_dim", index, src.shape[dim], True, f"dimension {dim}")
        return func(*args, **kwargs)


# the number of `checks()` regions open in this process; the GRU kernel
# wrappers scan their outputs while it is above 0 (a region may open on one
# thread while the autograd engine launches the backward's kernels on another)
_ACTIVE = 0
_LOCK = threading.Lock()


def active() -> bool:
    return _ACTIVE > 0


def check_kernel(kernel: str, outputs: dict, dims: dict) -> None:
    """What a GRU kernel wrapper calls after its launch: nothing unless a
    `checks()` region is open, else a NaN scan of the kernel's outputs."""
    if _ACTIVE:
        detail = " (" + " ".join(f"{k}={v}" for k, v in dims.items()) + ")"
        check_no_nan(kernel, outputs, detail)


@contextlib.contextmanager
def _kernel_checks():
    global _ACTIVE
    with _LOCK:
        _ACTIVE += 1
    try:
        yield
    finally:
        with _LOCK:
            _ACTIVE -= 1


@contextlib.contextmanager
def checks():
    """Every check of debug mode over the enclosed region. Yields the
    `DebugMode`, whose `threads` holds the ops it saw on each thread."""
    mode = DebugMode()
    with _kernel_checks(), torch.autograd.set_detect_anomaly(True), _TakeAlongDim(), mode:
        yield mode


def checked(fn):
    """`fn` run under `checks()` (the train iteration of a debug run); the
    attributes of `fn` (such as `train_iteration.update`) stay reachable."""

    def debug_fn(*args, **kwargs):
        with checks():
            return fn(*args, **kwargs)

    debug_fn.__dict__.update(fn.__dict__)
    debug_fn.__wrapped__ = fn
    return debug_fn
