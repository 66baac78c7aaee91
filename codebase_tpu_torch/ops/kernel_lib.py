"""The port's hand-written CUDA kernel library: its build, its load and the launch of its kernels.

Every hand-written kernel of the port sits in `csrc/fused_gru.cu`, in three
families: the GRU recurrence's `gru_*` (`ops/fused_gru.py`), the f32 weight
gradient's `grouped_dw*` (`ops/grouped_dw.py`) and the f32 Linear's
forward and input gradient, `grouped_mm*` (`ops/grouped_mm.py`).
`build_library` compiles it with nvcc for sm_90a into
`codebase_tpu_torch/_build/` at first use (a library built from the same
source and flags is reused), and `library(declare)` loads it once with
ctypes; each module passes its own `declare(lib)`, which sets its
functions' ctypes signatures and checks the library's sizes against its
own, once. Nothing here runs at import.

Every wrapper checks its tensors with `check` (CUDA, f32, contiguous,
16-byte aligned, of the expected shape; `aligned` makes a tensor so), and
launches through `launch`: the library function on the tensors' device
with its current stream appended, `raise_on` its error code naming the
kernel, the launch counted in `utils/profiling`'s counter registry, and
`launched(kernel, outputs, **dims)`, which hands each launch's kernel name,
outputs and shape to `LAUNCH_OBSERVERS`: in a debug region
(`utils/debug.py`) a NaN in an output raises naming the kernel, and while
`utils/profiling.count_operations` counts, it adds the launch's operations
and bytes (`kernel_flops`, `kernel_bytes`, by the rules each module enters
in `COSTS` for its kernels). No PyTorch tool sees these `ctypes` launches
otherwise. `ptr`, `stream` and `sms` are the launches' arguments.

The `DW_*` sizes are those of the long-K weight-gradient pipeline that
`gru_dw_kernel` and `grouped_dw_kernel` share: tiles of DW_TILE_M x
DW_TILE_N of dW, stages of DW_CHUNK rows in a TMA ring of DW_STAGES fp32
stages (40 KB each) beside two pairs of TF32 B buffers (24 KB each),
mbarriers and 1 KB of alignment slack, products in 3xTF32 on `wgmma`. Their
cost model (`fused_gru.dw_tiling`, `grouped_dw.grouped_dw_tiling`):
DW_STAGE_US, a block's time for a stage; DW_BLOCK_US, a block's fixed time
(the ring's fill and the epilogue); and the rate at which the partials are
written and read again.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Tuple

import torch

from codebase_tpu_torch.utils import debug, profiling

DW_CHUNK = 32
DW_TILE_M, DW_TILE_N = 128, 192
DW_STAGES = 3
DW_SMEM = DW_STAGES * 40_960 + 4 * 24_576 + 2 * DW_STAGES * 8 + 1024
DW_STAGE_US = 2.2
DW_BLOCK_US = 15.0
# the most stages a block sums in one wgmma accumulator: its error grows
# with the count (about 2.4e-7 of the largest entry a stage, measured on an
# H100), 3.3e-5 at 128 stages (4096 rows), against the 1e-4 it is held to
DW_MAX_STAGES = 128
DW_PARTIAL_BYTES_PER_US = 2.2e6

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_gru.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# what runs after each kernel launch, as fn(kernel name, outputs, dims): the
# debug mode's NaN scan of the outputs (nothing unless a debug region is
# open) and, while `utils/profiling.count_operations` counts, its count of
# the launch's operations and bytes
LAUNCH_OBSERVERS = [debug.check_kernel]
# kernel name -> (flops(kernel, dims), bytes(kernel, dims)) of one launch,
# entered by the module that launches the kernel
COSTS: Dict[str, Tuple[Callable, Callable]] = {}

_lib = None
_declared = set()
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def build_library() -> Path:
    """Compile `csrc/fused_gru.cu` into `_build/` unless a library built
    from the same source is already there; returns its path. The build log
    (including ptxas register and shared-memory use) sits beside it."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"fused_gru_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"fused_gru_{tag}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / f"fused_gru_{tag}.log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def library(declare: Callable):
    """The loaded library, built at the first call, with `declare(lib)` (a
    module's signatures and size checks) run once."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build_library()))
        if declare not in _declared:
            declare(_lib)
            _declared.add(declare)
        return _lib


def raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code}")


def check(shapes: dict, device) -> None:
    """Each of `shapes` ({name: (tensor, shape)}) a contiguous, 16-byte
    aligned f32 CUDA tensor of its shape on `device`."""
    for name, (t, shape) in shapes.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {device}; got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}; expected {tuple(shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels load float4)")


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def sms() -> int:
    return torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count


def aligned(t):
    """t contiguous at a 16-byte-aligned address (a copy where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(kernel: str, fn: Callable, args: tuple, counter: str, outputs: dict, **dims) -> None:
    """Launch `kernel` by the library function `fn`: `fn(*args, stream)` on
    the device of `outputs` ({name: tensor}) with its current stream; a
    nonzero code raises naming the kernel. Then the launch counts under
    `counter` and goes to `launched` with its outputs and shape `dims`."""
    dev = next(iter(outputs.values())).device
    with torch.cuda.device(dev):
        code = fn(*args, stream(dev))
    raise_on(code, f"{kernel} launch")
    profiling.count(counter)
    launched(kernel, outputs, **dims)


def launched(kernel: str, outputs: dict, **dims) -> None:
    for observe in LAUNCH_OBSERVERS:
        observe(kernel, outputs, dims)


def _costs(kernel: str) -> tuple:
    if kernel not in COSTS:
        raise ValueError(f"unknown kernel {kernel!r}")
    return COSTS[kernel]


def kernel_flops(kernel: str, dims: dict) -> float:
    """The operations of one launch of `kernel` at its shape `dims`."""
    return _costs(kernel)[0](kernel, dims)


def kernel_bytes(kernel: str, dims: dict) -> float:
    """The bytes one launch of `kernel` must move at its shape `dims`."""
    return _costs(kernel)[1](kernel, dims)
