"""The forward and input-gradient products of the grouped f32 Linear layers: kernels + plain version.

`ops/matmul.py`'s f32 Linear `y = x (G, R, K) @ w (G, K, N) + b (G, N)`
forms every f32 Linear layer, GRU input projection and QMIX mixer product
of the port. Its R is the layer's rows, (T+1)*B in an update (212,992 at
B=8192) or the envs of a rollout step (524,288), its K and N the widths
(15, 128, 384, 6, 166, 18, 1,660, ...). cuBLAS ran the forward and the input
gradient `dX = dy @ w^T` as FFMA GEMMs (TF32 is off for the process), and
the bias as a broadcast add that read and wrote y a second time (PERF.md).
The kernels here (`csrc/fused_gru.cu`, built and loaded with the GRU
kernels by `ops/kernel_lib.py`; they replace no TPU kernel, XLA forms these
products there) write `x @ B (+ b)` once, B = w or w read transposed:

- `grouped_mm_kernel` ("wgmma"): 3xTF32 on `wgmma`, as `gru_dw_kernel` and
  `grouped_dw_kernel`; a block stages a tile of 64 or 128 columns of B
  (all of K, or chunks of `kc` rows where that outgrows shared memory),
  split into TF32 parts, once; its warpgroups read x rows straight into
  registers (rows of K = 15 or 166 are not 16-byte aligned, so TMA cannot
  map them) and walk 64-row tiles of a persistent grid; the bias is added
  in the epilogue;
- `grouped_mm_ffma_kernel` ("ffma") for the thin products (N <= 32: the
  6- and 18-wide Q-value layers): exact FFMA, one row a thread, bound by
  bytes.

`product(x, w, b, counter)` is the forward (counter "linear/fwd", w (G, K,
N)) or the input gradient (counter "linear/dx", w (G, N, K) read
transposed, no bias). `mm_route(G, R, K, N)` sends a product to the kernels
or to cuBLAS from its shape alone: below `KERNEL_MIN_ROWS` rows of all
groups (by variant) cuBLAS is as fast (the crossover measured on an H100,
PERF.md), and a B too large for the kernels' shared memory stays on
cuBLAS. `mm_tiling` picks the variant and the launch. A CPU tensor never
reaches this module: `matmul.grouped_linear` keeps `torch.bmm` and the add
there. A CUDA tensor on the kernel route launches a kernel or raises; there
is no fallback. `grouped_mm_plain` is the plain version of the kernels'
split and sum, the reference of the tests.

Counters (`utils/profiling`'s registry): `("linear/fwd" | "linear/dx",
route, (G, R, K, N))` at each product (K its inner and N its outer width:
for the input gradient the layer's out and in widths), and
`linear_launch/mm` at each launch (`launch_counts()`; apart from the GRU
kernels' and the weight gradient's).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from codebase_tpu_torch.ops import kernel_lib
from codebase_tpu_torch.utils import profiling

LAUNCHES = {"mm": "linear_launch/mm"}
COUNTERS = ("linear/fwd", "linear/dx")

# the rows of all groups (G * R) from which a product goes to the kernels,
# by the variant that takes it; below them cuBLAS (with the add) is as fast
# or faster, the wrapper's host time included (an H100, back-to-back calls
# at G = 2, 10, 64: the wgmma kernel wins from 20k-80k rows by shape, the
# FFMA kernel from 128k-256k; PERF.md)
KERNEL_MIN_ROWS = {"wgmma": 65_536, "ffma": 131_072}
# grouped_mm_kernel (csrc): rows of a warpgroup's tile, k of a staged block
# of B, columns of one chunk, chunks a block
MM_ROWS = 64
MM_KBLOCK = 32
MM_CHUNK = 64
MM_MAX_CHUNKS = 2
# grouped_mm_ffma_kernel (csrc): rows a block (one a thread), k of a stage,
# a staged row's floats, stages in its ring; the widest product it takes
FFMA_ROWS = 256
FFMA_K = 32
FFMA_STRIDE = 36
FFMA_STAGES = 2
FFMA_MAX_N = 32
# the most dynamic shared memory an H100 block can have (csrc kSmemPerBlock)
SMEM_PER_BLOCK = 232_448


def launch_counts() -> dict:
    counts = profiling.counters()
    return {k: counts.get(name, 0) for k, name in LAUNCHES.items()}


def kernel_flops(kernel: str, dims: dict) -> float:
    """The operations of one launch: 2*R*K*N for each group's x @ B (dims
    G, R, K, N), the bias's adds left out."""
    return float(2 * dims["G"] * dims["R"] * dims["K"] * dims["N"])


def kernel_bytes(kernel: str, dims: dict) -> float:
    """The f32 bytes one launch must move, each input read once and y
    written once: x, B and b -> y."""
    R, K, N = dims["R"], dims["K"], dims["N"]
    return float(4 * dims["G"] * (R * K + K * N + R * N + N))


kernel_lib.COSTS.update({k: (kernel_flops, kernel_bytes) for k in ("grouped_mm_kernel", "grouped_mm_ffma_kernel")})


def mm_groups(chunks: int) -> int:
    """Warpgroups a block of the wgmma kernel with `chunks` 64-column chunks
    (csrc `mm_groups`): three where their registers fit, else two."""
    return 3 if chunks == 1 else 2


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def mm_smem(K: int, bn: int) -> int:
    """Bytes of dynamic shared memory of the wgmma kernel for K x bn of B:
    big and small parts (K padded to k-blocks), the bias, 1 KB of slack
    (csrc `mm_smem`)."""
    return 4 * (2 * _up(K, MM_KBLOCK) * bn + bn) + 1024


def ffma_smem(K: int, np_: int) -> int:
    """Bytes of dynamic shared memory of the FFMA kernel: the ring, B (K
    padded to stages, np_ columns) and the bias (csrc `mm_ffma_smem`)."""
    return 4 * (FFMA_STAGES * FFMA_ROWS * FFMA_STRIDE + _up(K, FFMA_K) * np_ + np_)


@functools.lru_cache(maxsize=512)
def mm_variant(K: int, N: int):
    """The kernel that takes a K x N product and its shape of B in shared
    memory, or None (cuBLAS keeps it). "ffma" for N <= FFMA_MAX_N where B
    fits, with np columns staged (N padded to 4). Else "wgmma" with `chunks`
    of 64 columns a block and B's rows in chunks of `kc` (all of K where it
    fits), the fewest bytes a row first: x once (a block's column tiles
    read the same rows at about the same time, from the L2) and y once, and
    again twice for each chunk of K past the first; then the fewest padded
    columns, then the most a block."""
    if N <= FFMA_MAX_N:
        np_ = _up(N, 4)
        return ("ffma", dict(np=np_)) if ffma_smem(K, np_) <= SMEM_PER_BLOCK else None
    best = None
    for chunks in range(MM_MAX_CHUNKS, 0, -1):
        bn = MM_CHUNK * chunks
        rows = (SMEM_PER_BLOCK - 1024 - 4 * bn) // (8 * bn) // MM_KBLOCK * MM_KBLOCK
        if rows < MM_KBLOCK:
            continue
        kc = min(_up(K, MM_KBLOCK), rows)
        cost = (K + (2 * -(-K // kc) - 1) * N, _up(N, bn) - N)
        if best is None or cost < best[0]:
            best = (cost, dict(chunks=chunks, kc=kc))
    return ("wgmma", best[1]) if best else None


def mm_route(G: int, R: int, K: int, N: int) -> str:
    """"kernel" or "cublas" for the product x (G, R, K) @ B (G, K, N), from
    its shape alone."""
    v = mm_variant(K, N)
    return "kernel" if v is not None and G * R >= KERNEL_MIN_ROWS[v[0]] else "cublas"


@functools.lru_cache(maxsize=512)
def mm_tiling(G: int, R: int, K: int, N: int, sms: int) -> dict:
    """The kernels' launch for a product on a card of `sms` SMs: {variant,
    chunks, bn, kc, np, grid, smem}. The wgmma kernel's grid is persistent:
    one block an SM shared among the (column tile, group) pairs, and no more
    blocks than the 64-row tiles fill."""
    variant, shape = mm_variant(K, N)
    if variant == "ffma":
        return dict(variant=variant, np=shape["np"], grid=(-(-R // FFMA_ROWS), 1, G), smem=ffma_smem(K, shape["np"]))
    bn = MM_CHUNK * shape["chunks"]
    col_tiles = -(-N // bn)
    tiles = -(-R // MM_ROWS)
    blocks = max(1, min(-(-tiles // mm_groups(shape["chunks"])), sms // (col_tiles * G)))
    return dict(variant=variant, chunks=shape["chunks"], bn=bn, kc=shape["kc"], grid=(blocks, col_tiles, G),
                smem=mm_smem(min(K, shape["kc"]), bn))


# ---------------------------------------------------------------------------
# Plain PyTorch version (the reference of the tests)
# ---------------------------------------------------------------------------


def tf32_split(t):
    """t = big + small as the kernels split it: big rounded to TF32 (10
    mantissa bits, to nearest, ties away from zero), small the rest, read by
    the tensor cores as TF32 by truncation."""
    bits = t.contiguous().view(torch.int32)
    big = ((bits + 0x1000) & -0x2000).view(torch.float32)
    small = ((t - big).contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    return big, small


def grouped_mm_plain(x, w, b=None, trans=False):
    """The kernels' product plainly: x (G, R, K) @ B + b, B = w (G, K, N)
    or, with `trans`, w (G, N, K) transposed; each operand split as
    `tf32_split` does, the three products small * big + big * small + big *
    big summed in f32, then the bias added."""
    B = w.transpose(1, 2) if trans else w
    xb, xs = tf32_split(x)
    bb, bs = tf32_split(B)
    y = torch.bmm(xs, bb) + torch.bmm(xb, bs) + torch.bmm(xb, bb)
    return y if b is None else y + b[:, None, :]


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


def _library():
    """The kernel library (`kernel_lib.library`) with these kernels'
    functions declared and its sizes checked against this module's."""
    return kernel_lib.library(_declare)


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grouped_mm.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.grouped_mm_ffma.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.grouped_mm_smem.argtypes = [i, i]
    lib.grouped_mm_ffma_smem.argtypes = [i, i]
    lib.grouped_mm_groups.argtypes = [i]
    sizes = (lib.grouped_mm_rows, lib.grouped_mm_ffma_rows)
    for fn in sizes:
        fn.argtypes = []
    for fn in (lib.grouped_mm, lib.grouped_mm_ffma, lib.grouped_mm_smem, lib.grouped_mm_ffma_smem, lib.grouped_mm_groups,
               *sizes):
        fn.restype = i
    if tuple(fn() for fn in sizes) != (MM_ROWS, FFMA_ROWS) or any(
            lib.grouped_mm_groups(c) != mm_groups(c) for c in range(1, MM_MAX_CHUNKS + 1)) or any(
            lib.grouped_mm_smem(K, bn) != mm_smem(K, bn) for K, bn in ((15, 128), (128, 128), (384, 64), (448, 64))
    ) or any(lib.grouped_mm_ffma_smem(K, n) != ffma_smem(K, n) for K, n in ((128, 8), (128, 20), (640, 32))):
        raise RuntimeError("kernel library sizes the grouped product otherwise")


def _dims(x, w, b, trans) -> tuple:
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[2 if trans else 1]:
        raise ValueError(f"x must be (G, R, K) and w (G, {'N, K' if trans else 'K, N'}); got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    G, R, K = x.shape
    N = w.shape[1 if trans else 2]
    if min(G, R, K, N) < 1:
        raise ValueError(f"empty product: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if b is not None and (trans or tuple(b.shape) != (G, N)):
        raise ValueError(f"the bias must be (G, N) = {(G, N)} of a forward product; got "
                         f"{tuple(b.shape)}{' with w transposed' if trans else ''}")
    return G, R, K, N


def grouped_mm_cuda(x, w, b=None, trans=False):
    """x (G, R, K) @ B (+ b (G, N)) by the kernel `mm_tiling` picks, B = w
    (G, K, N) or, with `trans`, w (G, N, K) read transposed -> y (G, R, N)."""
    G, R, K, N = _dims(x, w, b, trans)
    if mm_variant(K, N) is None:
        raise ValueError(f"no kernel takes a {K} x {N} product: its B outgrows shared memory")
    dev = x.device
    shapes = {"x": (x, (G, R, K)), "w": (w, tuple(w.shape))}
    if b is not None:
        shapes["b"] = (b, (G, N))
    kernel_lib.check(shapes, dev)
    lib = _library()
    tile = mm_tiling(G, R, K, N, kernel_lib.sms())
    y = torch.empty((G, R, N), device=dev)
    bias = kernel_lib.ptr(b) if b is not None else None
    args = (kernel_lib.ptr(x), kernel_lib.ptr(w), bias, kernel_lib.ptr(y), G, R, K, N, int(trans))
    with torch.cuda.device(dev):
        if tile["variant"] == "wgmma":
            code = lib.grouped_mm(*args, tile["chunks"], tile["kc"], tile["grid"][0], kernel_lib.stream(dev))
        else:
            code = lib.grouped_mm_ffma(*args, tile["np"], kernel_lib.stream(dev))
    kernel = "grouped_mm_kernel" if tile["variant"] == "wgmma" else "grouped_mm_ffma_kernel"
    kernel_lib.raise_on(code, f"{kernel} launch")
    profiling.count(LAUNCHES["mm"])
    kernel_lib.launched(kernel, {"y": y}, G=G, R=R, K=K, N=N)
    return y


def _aligned(t):
    """t contiguous at a 16-byte-aligned address (a copy where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def product(x, w, b=None, counter: str = "linear/fwd"):
    """The f32 Linear's product on CUDA tensors: the forward x (G, R, K) @ w
    (G, K, N) + b (counter "linear/fwd") or the input gradient dy (G, R, N)
    @ w^T of a layer whose w is (G, K, N) (counter "linear/dx", no bias),
    by the kernels where `mm_route` sends the shape, else by cuBLAS
    (`torch.bmm`, then the add). Counted as `(counter, route, (G, R, inner,
    outer))`."""
    trans = counter == "linear/dx"
    G, R, K = x.shape
    N = w.shape[1 if trans else 2]
    route = mm_route(G, R, K, N)
    profiling.count((counter, route, (G, R, K, N)))
    if route == "cublas":
        y = torch.bmm(x, w.transpose(1, 2) if trans else w)
        return y if b is None else y + b[:, None, :]
    return grouped_mm_cuda(_aligned(x), _aligned(w), None if b is None else _aligned(b), trans)
