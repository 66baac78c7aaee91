"""GRU recurrence over a whole sequence: hand-written CUDA kernels + plain version.

Replaces the Pallas TPU kernels of the JAX package's `ops/fused_gru.py`
(`_fwd_kernel`, `_bwd_kernel`) with kernels in `csrc/fused_gru.cu`, each
forming its products on tensor cores in 3xTF32 (each operand split into two
TF32 parts, three products summed in f32), so results stay at f32 level.
They take what the TPU kernel takes, H % 128 == 0, up to `MAX_HIDDEN`
(`kernel_variant`). At H=128:

- `gru_fwd` (replaces `_fwd_kernel`): the recurrence over all T steps in
  one launch on a persistent grid of about one block per SM. Each block
  stages W_hh once in shared memory, keeps its 16-row h tile there for all
  T steps, and forms `h @ W_hh`. Bound by the work of each tile (the three
  products, the splits, the gates), under which its bytes hide; at the
  update shape that work is also a serial chain over T.
- `gru_bwd` (replaces `_bwd_kernel`'s recurrence): BPTT in reverse time on
  the forward's grid, with W_hh in shared memory, rematerialising the gates
  from `h_prev = h0 || y[:-1]` and `gi` instead of saving activations. Per
  step it forms `h_prev @ W_hh` and `dgh @ W_hh^T`, and keeps dh in
  registers. It emits `dgi`, `dh0` and `dgh_n = dgi_n * r`, the one part of
  `dgh` that `dgi` does not hold. Bound, like the forward, by the work of
  each step, here on a chain of T steps.
- `gru_dw` (replaces `_bwd_kernel`'s `dW_hh`/`db_hh` products): the weight
  gradient, off the recurrence's chain, as one long-K product over the
  T*B rows of `h_prev` and `dgh = [dgi_r, dgi_z, dgh_n]`, split over K into
  per-block partial sums.
- `gru_reduce` (replaces the in-order `dW_hh`/`db_hh` accumulation of
  `_bwd_kernel`): sums those partials. On the TPU the accumulation into one
  output block is race-free because grid steps run in order; GPU blocks
  run in parallel, so each writes its own partial and this kernel reduces
  them, bound by bytes, in a fixed order (deterministic, no atomics).

At 256 <= H <= MAX_HIDDEN, W_hh (3 MB at H=512) does not fit in shared
memory, and two wide variants take the recurrences: `gru_fwd_wide` and
`gru_bwd_wide`, one block per 16-row tile, reading W_hh from the L2 at
every step. `gru_dw` and `gru_reduce` serve every H.

The header of `csrc/fused_gru.cu` says what bounds each kernel and what the
design does about it. The library is built with nvcc for sm_90a at first
use, into `codebase_tpu_torch/_build/`, and loaded with ctypes.

Dispatch: a CPU tensor goes through the plain PyTorch version
(`gru_sequence_plain`, a loop of GRU-cell tensor ops with autograd through
it); a CUDA tensor launches the kernels or raises. There is no fallback.
The backward's plain versions (`gru_bwd_plain`, `gru_dw_plain` and their
composition `gru_backward_plain`) are the references the kernels are held
to; no path runs them on a CUDA tensor.
Every tensor carries a leading group axis G (agents or sharing groups): one
launch covers all groups.

Launch counters (`FWD_LAUNCHES`, `BWD_LAUNCHES`, `FWD_WIDE_LAUNCHES`,
`BWD_WIDE_LAUNCHES`, `DW_LAUNCHES`, `REDUCE_LAUNCHES`) rise by one where a
kernel is launched and nowhere else, so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from codebase_tpu_torch.ops.matmul import grouped_matmul

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
FWD_WIDE_LAUNCHES = 0
BWD_WIDE_LAUNCHES = 0
DW_LAUNCHES = 0
REDUCE_LAUNCHES = 0

RESIDENT_HIDDEN = 128  # the hidden size of the kernels that hold W_hh in shared memory
MAX_HIDDEN = 896  # the wide kernels' largest H: the backward's tiles fill shared memory

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_gru.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES, FWD_WIDE_LAUNCHES, BWD_WIDE_LAUNCHES, DW_LAUNCHES, REDUCE_LAUNCHES
    FWD_LAUNCHES = BWD_LAUNCHES = FWD_WIDE_LAUNCHES = BWD_WIDE_LAUNCHES = DW_LAUNCHES = REDUCE_LAUNCHES = 0


def launch_counts() -> dict:
    return {"fwd": FWD_LAUNCHES, "bwd": BWD_LAUNCHES, "fwd_wide": FWD_WIDE_LAUNCHES,
            "bwd_wide": BWD_WIDE_LAUNCHES, "dw": DW_LAUNCHES, "reduce": REDUCE_LAUNCHES}


def kernel_variant(H: int):
    """Which recurrence kernels take hidden size H: "resident" (H=128, W_hh
    in shared memory), "wide" (H % 128 == 0 up to MAX_HIDDEN) or None."""
    if H == RESIDENT_HIDDEN:
        return "resident"
    if H % 128 == 0 and RESIDENT_HIDDEN < H <= MAX_HIDDEN:
        return "wide"
    return None


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU path; the reference the kernels are held to)
# ---------------------------------------------------------------------------


def gru_sequence_plain(gi, w_hh, b_hh, h0):
    """gi (G, T, B, 3H), w_hh (G, H, 3H), b_hh (G, 3H), h0 (G, B, H) ->
    (y (G, T, B, H), hT (G, B, H)); torch gate order [r, z, n]."""
    H = h0.shape[-1]
    h = h0
    ys = []
    for t in range(gi.shape[1]):
        gh = torch.bmm(h, w_hh) + b_hh[:, None, :]
        gi_t = gi[:, t]
        r = torch.sigmoid(gi_t[..., :H] + gh[..., :H])
        z = torch.sigmoid(gi_t[..., H : 2 * H] + gh[..., H : 2 * H])
        n = torch.tanh(gi_t[..., 2 * H :] + r * gh[..., 2 * H :])
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return torch.stack(ys, dim=1), h


def _h_prev(h0, y):
    """h_prev = h0 || y[:-1], (G, T, B, H)."""
    return torch.cat([h0[:, None], y[:, :-1]], dim=1)


def gru_bwd_plain(gi, w_hh, b_hh, h0, y, dy, dhT):
    """The plain version of `gru_bwd`, the reverse-time recurrence: gates
    rematerialised from h_prev = h0 || y[:-1] and gi. Returns (dgi (G, T, B,
    3H), dh0 (G, B, H), dgh_n (G, T, B, H)) with dgh = [dgi_r, dgi_z, dgh_n]."""
    H = h0.shape[-1]
    h_prev = _h_prev(h0, y)
    dh = dhT
    dgi, dgh_n = torch.empty_like(gi), torch.empty_like(y)
    for t in reversed(range(gi.shape[1])):
        hp, gi_t = h_prev[:, t], gi[:, t]
        gh = torch.bmm(hp, w_hh) + b_hh[:, None, :]
        r = torch.sigmoid(gi_t[..., :H] + gh[..., :H])
        z = torch.sigmoid(gi_t[..., H : 2 * H] + gh[..., H : 2 * H])
        n = torch.tanh(gi_t[..., 2 * H :] + r * gh[..., 2 * H :])
        dht = dy[:, t] + dh
        dn = dht * (1.0 - z) * (1.0 - n * n)
        dr = dn * gh[..., 2 * H :] * r * (1.0 - r)
        dz = dht * (hp - n) * z * (1.0 - z)
        dgi[:, t] = torch.cat([dr, dz, dn], dim=-1)
        dgh_n[:, t] = dn * r
        dgh = torch.cat([dr, dz, dn * r], dim=-1)
        dh = dht * z + torch.bmm(dgh, w_hh.transpose(1, 2))
    return dgi, dh, dgh_n


def gru_dw_plain(h0, y, dgi, dgh_n):
    """The plain version of `gru_dw` and the reduction:
    dW_hh = sum over (t, b) of h_prev^T dgh, db_hh = sum of dgh, with
    dgh = [dgi_r, dgi_z, dgh_n]. Returns (dW_hh (G, H, 3H), db_hh (G, 3H))."""
    G, T, B, H = y.shape
    h_prev = _h_prev(h0, y).reshape(G, T * B, H)
    dgh = torch.cat([dgi[..., : 2 * H], dgh_n], dim=-1).reshape(G, T * B, 3 * H)
    return torch.bmm(h_prev.transpose(1, 2), dgh), dgh.sum(1)


def gru_backward_plain(gi, w_hh, b_hh, h0, y, dy, dhT):
    """The backward's plain version, the same function as
    `gru_backward_cuda`: (dgi, dW_hh, db_hh, dh0)."""
    dgi, dh0, dgh_n = gru_bwd_plain(gi, w_hh, b_hh, h0, y, dy, dhT)
    dw, db = gru_dw_plain(h0, y, dgi, dgh_n)
    return dgi, dw, db, dh0


def reduce_partials_plain(partials):
    """partials (G, P, E) -> (G, E): the plain version of `gru_reduce`."""
    return partials.sum(1)


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


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


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.gru_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
            lib.gru_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
            lib.gru_fwd_wide.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
            lib.gru_bwd_wide.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, p]
            lib.gru_dw.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
            lib.gru_reduce.argtypes = [p, p, i, i, i, p]
            lib.gru_dw_tiles.argtypes = [i]
            sizes = (lib.gru_max_hidden, lib.gru_fwd_rows, lib.gru_dw_chunk)
            for fn in (lib.gru_fwd, lib.gru_bwd, lib.gru_fwd_wide, lib.gru_bwd_wide, lib.gru_dw,
                       lib.gru_reduce, lib.gru_dw_tiles, *sizes):
                fn.restype = i
            for fn in sizes:
                fn.argtypes = []
            if lib.gru_max_hidden() != MAX_HIDDEN:
                raise RuntimeError("fused GRU library was built for other hidden sizes")
            _lib = lib
        return _lib


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code}")


def _check(shapes: dict, device) -> None:
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


def _dims(gi):
    if gi.ndim != 4:
        raise ValueError(f"gi must be (G, T, B, 3H); got shape {tuple(gi.shape)}")
    G, T, B, H3 = gi.shape
    H = H3 // 3
    if H3 != 3 * H or kernel_variant(H) is None:
        raise ValueError(f"the GRU kernels take H % 128 == 0 up to H={MAX_HIDDEN}; got 3H={H3}")
    if min(G, T, B) < 1:
        raise ValueError(f"empty GRU input of shape {tuple(gi.shape)}")
    return G, T, B, H


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


def _sms() -> int:
    return torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count


def forward_blocks_per_group(G: int, B: int, rows: int) -> int:
    """Blocks per group of the persistent forward grid. A block holds W_hh
    (192 KB) in shared memory, so one fits on an SM: at most `sms // G` per
    group, each walking tiles of `rows` rows. Small tiles let a short batch
    (the update shape, G=2 B=1024: 128 tiles of 16) spread its serial chains
    over the card."""
    return max(1, min(-(-B // rows), _sms() // G))


def gru_fwd_cuda(gi, w_hh, b_hh, h0):
    """Kernel 1, `gru_fwd` at H=128, `gru_fwd_wide` above:
    (y (G, T, B, H), hT (G, B, H))."""
    global FWD_LAUNCHES, FWD_WIDE_LAUNCHES
    G, T, B, H = _dims(gi)
    dev = gi.device
    _check(
        {"gi": (gi, (G, T, B, 3 * H)), "w_hh": (w_hh, (G, H, 3 * H)),
         "b_hh": (b_hh, (G, 3 * H)), "h0": (h0, (G, B, H))},
        dev,
    )
    lib = _library()
    y = torch.empty((G, T, B, H), device=dev)
    hT = torch.empty((G, B, H), device=dev)
    args = (_ptr(gi), _ptr(w_hh), _ptr(b_hh), _ptr(h0), _ptr(y), _ptr(hT), G, T, B, H)
    wide = kernel_variant(H) == "wide"
    with torch.cuda.device(dev):
        if wide:
            code = lib.gru_fwd_wide(*args, _stream(dev))
        else:
            code = lib.gru_fwd(*args, forward_blocks_per_group(G, B, lib.gru_fwd_rows()), _stream(dev))
    _raise_on(code, "gru_fwd_wide launch" if wide else "gru_fwd launch")
    if wide:
        FWD_WIDE_LAUNCHES += 1
    else:
        FWD_LAUNCHES += 1
    return y, hT


def gru_bwd_cuda(gi, w_hh, b_hh, h0, y, dy, dhT):
    """Kernel 2, the reverse-time recurrence (`gru_bwd` on the forward's
    persistent grid at H=128, `gru_bwd_wide` above): (dgi (G, T, B, 3H),
    dh0 (G, B, H), dgh_n (G, T, B, H))."""
    global BWD_LAUNCHES, BWD_WIDE_LAUNCHES
    G, T, B, H = _dims(gi)
    dev = gi.device
    _check(
        {"gi": (gi, (G, T, B, 3 * H)), "w_hh": (w_hh, (G, H, 3 * H)),
         "b_hh": (b_hh, (G, 3 * H)), "h0": (h0, (G, B, H)), "y": (y, (G, T, B, H)),
         "dy": (dy, (G, T, B, H)), "dhT": (dhT, (G, B, H))},
        dev,
    )
    lib = _library()
    dgi = torch.empty_like(gi)
    dh0 = torch.empty_like(h0)
    dgh_n = torch.empty_like(y)
    args = (_ptr(gi), _ptr(w_hh), _ptr(b_hh), _ptr(h0), _ptr(y), _ptr(dy), _ptr(dhT), _ptr(dgi),
            _ptr(dh0), _ptr(dgh_n), G, T, B, H)
    wide = kernel_variant(H) == "wide"
    with torch.cuda.device(dev):
        if wide:
            code = lib.gru_bwd_wide(*args, _stream(dev))
        else:
            code = lib.gru_bwd(*args, forward_blocks_per_group(G, B, lib.gru_fwd_rows()), _stream(dev))
    _raise_on(code, "gru_bwd_wide launch" if wide else "gru_bwd launch")
    if wide:
        BWD_WIDE_LAUNCHES += 1
    else:
        BWD_LAUNCHES += 1
    return dgi, dh0, dgh_n


def dw_blocks_per_group(G: int, K: int, tiles: int, chunk: int) -> tuple:
    """Split of the dW_hh product's K = T*B rows: (P, rows), P blocks per
    tile of dW_hh, each summing `rows` rows (a multiple of `chunk`), about
    one block per SM over all groups and tiles; P=1 (every row in one
    block) once the tiles alone fill the card, as at H=512 G=10 (640 tiles)."""
    rows = -(-K // max(1, _sms() // (G * tiles)))
    rows = -(-rows // chunk) * chunk
    return -(-K // rows), rows


def gru_dw_cuda(h0, y, dgi, dgh_n):
    """Kernel 3, dW_hh and db_hh over K = T*B rows: partials (G, P, H*3H + 3H),
    where partials[g, p] holds the share of rows block p summed of
    [dW_hh[g] | db_hh[g]]."""
    global DW_LAUNCHES
    G, T, B, H = _dims(dgi)
    dev = dgi.device
    _check(
        {"h0": (h0, (G, B, H)), "y": (y, (G, T, B, H)), "dgi": (dgi, (G, T, B, 3 * H)),
         "dgh_n": (dgh_n, (G, T, B, H))},
        dev,
    )
    lib = _library()
    P, rows = dw_blocks_per_group(G, T * B, lib.gru_dw_tiles(H), lib.gru_dw_chunk())
    partials = torch.empty((G, P, H * 3 * H + 3 * H), device=dev)
    with torch.cuda.device(dev):
        code = lib.gru_dw(
            _ptr(h0), _ptr(y), _ptr(dgi), _ptr(dgh_n), _ptr(partials), G, T, B, H, P, rows,
            _stream(dev),
        )
    _raise_on(code, "gru_dw launch")
    DW_LAUNCHES += 1
    return partials


def reduce_partials_cuda(partials):
    """Kernel 4: partials (G, P, E) -> (G, E), summed over P in order (two
    calls give bitwise-equal results)."""
    global REDUCE_LAUNCHES
    if partials.ndim != 3:
        raise ValueError(f"partials must be (G, P, E); got {tuple(partials.shape)}")
    G, P, E = partials.shape
    dev = partials.device
    _check({"partials": (partials, (G, P, E))}, dev)
    lib = _library()
    out = torch.empty((G, E), device=dev)
    with torch.cuda.device(dev):
        code = lib.gru_reduce(_ptr(partials), _ptr(out), G, P, E, _stream(dev))
    _raise_on(code, "gru_reduce launch")
    REDUCE_LAUNCHES += 1
    return out


def gru_backward_cuda(gi, w_hh, b_hh, h0, y, dy, dhT):
    """Kernels 2-4, the recurrence, the weight gradient and the reduction:
    (dgi, dW_hh, db_hh, dh0)."""
    H = h0.shape[-1]
    dgi, dh0, dgh_n = gru_bwd_cuda(gi, w_hh, b_hh, h0, y, dy, dhT)
    sums = reduce_partials_cuda(gru_dw_cuda(h0, y, dgi, dgh_n))
    dw = sums[:, : H * 3 * H].reshape(w_hh.shape)
    db = sums[:, H * 3 * H :]
    return dgi, dw, db, dh0


class FusedGRUSequence(torch.autograd.Function):
    """The recurrence on CUDA tensors: forward is kernel 1; backward is
    kernels 2-4 (`gru_backward_cuda`). Saves (gi, w_hh, b_hh, h0, y)."""

    @staticmethod
    def forward(ctx, gi, w_hh, b_hh, h0):
        y, hT = gru_fwd_cuda(gi, w_hh, b_hh, h0)
        ctx.save_for_backward(gi, w_hh, b_hh, h0, y)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        gi, w_hh, b_hh, h0, y = ctx.saved_tensors
        return gru_backward_cuda(gi, w_hh, b_hh, h0, y, dy.contiguous(), dhT.contiguous())


def fused_gru_sequence(gi, w_hh, b_hh, h0):
    """GRU recurrence over a whole sequence with a leading group axis.

    gi (G, T, B, 3H) = x @ w_ih + b_ih, w_hh (G, H, 3H), b_hh (G, 3H),
    h0 (G, B, H) -> (y (G, T, B, H), hT (G, B, H)). Differentiable. CPU
    tensors take the plain version; CUDA tensors the kernels."""
    if gi.device.type == "cpu":
        return gru_sequence_plain(gi, w_hh, b_hh, h0)
    if gi.device.type == "cuda":
        return FusedGRUSequence.apply(gi, w_hh, b_hh, h0)
    raise ValueError(f"fused_gru_sequence runs on cpu or cuda tensors; got {gi.device}")


def gru_layer_sequence(params, x, h0, compute_dtype: str = "float32"):
    """Full GRU layer: the input projection as one matmul (bf16 inputs and
    an f32 result under `compute_dtype="bfloat16"`, as the JAX package's
    layer), then the fused recurrence, in f32 at every dtype.
    params {w_ih (G, in, 3H), w_hh, b_ih (G, 3H), b_hh},
    x (G, T, B, in), h0 (G, B, H) -> (y (G, T, B, H), hT (G, B, H))."""
    G, T, B, D = x.shape
    w_ih = params["w_ih"]
    gi = grouped_matmul(x.reshape(G, T * B, D), w_ih, compute_dtype).view(G, T, B, w_ih.shape[-1])
    gi = gi + params["b_ih"][:, None, None, :]
    return fused_gru_sequence(gi, params["w_hh"], params["b_hh"], h0.contiguous())
