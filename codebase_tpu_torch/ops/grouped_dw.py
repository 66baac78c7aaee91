"""The weight gradient of the grouped f32 products: a split-K kernel + plain version.

`ops/matmul.py`'s f32 product `x (G, K, M) @ w (G, M, N)` forms every f32
Linear layer and GRU input projection of the port. Its weight gradient
`dW[g] = x[g]^T dy[g]` (M x N) has a tiny M x N and a long K: the layer's
rows, (T+1)*B in an update (212,992 at B=8192). cuBLAS ran it as a
strided-batched FFMA GEMM of 32 x 32 tiles that does not split K, at about
2% of its bound on an H100 (PERF.md). The kernels here (`csrc/fused_gru.cu`,
built and loaded with the GRU kernels by `ops/kernel_lib.py`; they replace
no TPU kernel, XLA forms these products there) split K over many blocks, each summing its rows into
a partial of its own, and sum the partials in a fixed order:

- `grouped_dw_kernel` ("wgmma") where M and N are multiples of 4 and the
  product fills a third of a 128 x 192 tile: the long-K pipeline it shares
  with `gru_dw_kernel` (`dw_pipeline`: tiles of 128 x 192, a TMA ring of
  32-row stages, 3xTF32 on `wgmma`), with A = x and B = dy and a block's
  stages summed in runs of at most `kernel_lib.DW_MAX_STAGES`;
- `grouped_dw_ffma_kernel` ("ffma") for the rest, the narrow products
  among them (15-wide observations, 6-wide Q-value gradients, whose rows
  TMA cannot map): exact FFMA over zero-padded `cp.async` stages, bound by
  bytes;
- `grouped_dw_reduce_kernel`: the partials' sum in a fixed order, P split
  eight ways (a small dW has few entries for many partials), under a name
  of its own (no GRU kernel's time holds this work).

`weight_gradient(x, dy)` is the backward's dW. `dw_route(G, K, M, N)` sends
a shape to the kernels or to cuBLAS, from the shape alone: below
`KERNEL_MIN_K` rows (by variant) cuBLAS is as fast (the crossover measured
on an H100, PERF.md). `grouped_dw_tiling` picks the variant, its tile and the split of
K. A CPU tensor never reaches this module: `matmul.grouped_linear` keeps
`torch.bmm` there. A CUDA tensor on the kernel route launches the kernels
or raises; there is no fallback. `grouped_dw_plain` is the plain version of
the kernels' split and sum, the reference of the tests.

Counters (`utils/profiling`'s registry): `linear_launch/dw` and
`linear_launch/reduce` at each launch (`launch_counts()`; apart from the
GRU kernels' `fused_gru.LAUNCHES`), and `("linear/dw", route, (G, K, M,
N))` at each weight gradient. The span `linear/dw` holds the weight
gradient's launches, the kernels' or cuBLAS's.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from codebase_tpu_torch.ops import kernel_lib
from codebase_tpu_torch.ops.kernel_lib import aligned
from codebase_tpu_torch.utils import profiling

LAUNCHES = {"dw": "linear_launch/dw", "reduce": "linear_launch/reduce"}

# the rows of K from which a weight gradient goes to the kernels, by the
# variant that takes it; below them cuBLAS is faster (an H100 at G=2, the
# cells' three products: the FFMA kernel wins from K=250, loses at K=100;
# the wgmma kernel wins from K=832, loses at K=250; PERF.md)
KERNEL_MIN_K = {"ffma": 200, "wgmma": 512}
# the most bytes of partials a call may take (P > 1; at P = 1 the kernel
# writes dW itself)
MAX_SCRATCH_BYTES = 16 * 2**20
# the wgmma kernel sums a block's stages in runs of equal length, at most
# `kernel_lib.DW_MAX_STAGES` (its accumulator's error grows with the stages it
# sums), each added into the block's partial: RUN_US, the time a run's end
# costs (fitted on an H100: runs of 32, 64 and 202 stages at 128 x 384,
# K=212,992)
RUN_US = 24.0
# the FFMA kernel (csrc grouped_dw_ffma_kernel): 256 threads, a ring of
# FFMA_STAGES stages of FFMA_ROWS rows. Its cost model: waves of
# FFMA_BLOCKS_PER_SM blocks an SM (fewer where shared memory is short;
# three keep an SM's share of the bandwidth busy: splits into 131-196
# blocks a group ran faster than into 256 on an H100), a block's time for a
# stage from its bytes and fused multiply-adds at an SM's rates, and a
# block's fixed time
FFMA_THREADS = 256
FFMA_ROWS = 32
FFMA_STAGES = 3
FFMA_BLOCKS_PER_SM = 3
SMEM_PER_SM = 233_472
FFMA_SM_BYTES_PER_US = 20_000.0
FFMA_SM_FMA_PER_US = 135_000.0
FFMA_BLOCK_US = 5.0
# the ways the reduction splits P (csrc kRedRows)
REDUCE_ROWS = 8



def launch_counts() -> dict:
    counts = profiling.counters()
    return {k: counts.get(name, 0) for k, name in LAUNCHES.items()}


def kernel_flops(kernel: str, dims: dict) -> float:
    """The operations of one launch: 2*M*N*K for each group's x^T dy over K
    rows (dims G, K, M, N), the reduction's adds (dims G, P, E)."""
    if kernel == "grouped_dw_reduce_kernel":
        return float(dims["G"] * (dims["P"] - 1) * dims["E"])
    return float(2 * dims["G"] * dims["K"] * dims["M"] * dims["N"])


def kernel_bytes(kernel: str, dims: dict) -> float:
    """The f32 bytes one launch must move, each input read once and each
    output written once, no partials: x, dy -> dW; the reduction's P
    partials -> their sum."""
    if kernel == "grouped_dw_reduce_kernel":
        return float(4 * dims["G"] * (dims["P"] + 1) * dims["E"])
    K, M, N = dims["K"], dims["M"], dims["N"]
    return float(4 * dims["G"] * (K * M + K * N + M * N))


kernel_lib.COSTS.update({k: (kernel_flops, kernel_bytes)
                         for k in ("grouped_dw_kernel", "grouped_dw_ffma_kernel", "grouped_dw_reduce_kernel")})


def dw_route(G: int, K: int, M: int, N: int) -> str:
    """"kernel" or "cublas" for the weight gradient of a (G, K, M) x
    (G, K, N) product, from its shape alone."""
    return "kernel" if K >= KERNEL_MIN_K["wgmma" if wgmma_variant(M, N) else "ffma"] else "cublas"


def wgmma_variant(M: int, N: int) -> bool:
    """Whether the wgmma kernel takes an M x N product: rows TMA can map
    (M, N multiples of 4) and at least a third of a 128 x 192 tile's work.
    Below that the FFMA kernel is faster (an H100, G=2, K=212,992: 64 x 64
    0.150 against 0.201 ms; 128 x 128 0.572 against 0.204 ms)."""
    return M % 4 == 0 and N % 4 == 0 and M * N >= 64 * 128


def _pow2(n: int) -> int:
    return 1 << max(2, (n - 1).bit_length())


def ffma_tile(M: int, N: int) -> tuple:
    """The FFMA kernel's tile (bm, bn) for an M x N product: powers of two
    of at least 4, at most 128 each and 4096 entries (16 a thread), the
    narrow side as narrow as the product."""
    if N <= M:
        bn = min(_pow2(N), 64)
        return min(_pow2(M), 128, 4096 // bn), bn
    bm = min(_pow2(M), 64)
    return bm, min(_pow2(N), 128, 4096 // bm)


def ffma_smem(bm: int, bn: int) -> int:
    """Bytes of dynamic shared memory of the FFMA kernel at a tile: the
    ring, or the slices' sums where they take more (csrc `ffma_smem`)."""
    return 4 * max(FFMA_STAGES * FFMA_ROWS * (bm + bn), (FFMA_THREADS - bm * bn // 16) * 16)


@functools.lru_cache(maxsize=256)
def grouped_dw_tiling(G: int, K: int, M: int, N: int, sms: int) -> dict:
    """The weight gradient's launch for a shape on a card of `sms` SMs.

    variant: "wgmma" where `wgmma_variant` takes the product (tiles of 128 x
    192, stages of 32 rows, one block an SM), else "ffma" (tiles of
    `ffma_tile`, stages of FFMA_ROWS rows, as many blocks an SM as shared
    memory and FFMA_BLOCKS_PER_SM allow). Each block sums `stages`
    consecutive stages for one tile, and P blocks share a tile's stages. The
    cost of a split is its waves of blocks times a block's time (the wgmma
    kernel's with RUN_US a run past the first), plus the P partials written
    and read again by the reduction (`dw_tiling`'s model, with its
    constants for the wgmma kernel); the partials take at most
    MAX_SCRATCH_BYTES. The cheapest P wins, the smaller on a tie. Returns
    {variant, tile, tiles, P, stages, rows (stages * stage rows), grid
    (tiles, P, G), waves, smem, scratch_bytes}."""
    if wgmma_variant(M, N):
        variant, tile, stage_rows = "wgmma", (kernel_lib.DW_TILE_M, kernel_lib.DW_TILE_N), kernel_lib.DW_CHUNK
        smem = kernel_lib.DW_SMEM
        slots, stage_us, block_us, run_us = sms, kernel_lib.DW_STAGE_US, kernel_lib.DW_BLOCK_US, RUN_US
    else:
        variant, tile, stage_rows = "ffma", ffma_tile(M, N), FFMA_ROWS
        smem = ffma_smem(*tile)
        per_sm = min(FFMA_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024))
        bm, bn = tile
        stage_bytes = 4 * stage_rows * (min(M, bm) + min(N, bn))
        stage_us = per_sm * max(stage_bytes / FFMA_SM_BYTES_PER_US, stage_rows * bm * bn / FFMA_SM_FMA_PER_US)
        slots, block_us, run_us = sms * per_sm, FFMA_BLOCK_US, 0.0
    tiles = -(-M // tile[0]) * -(-N // tile[1])
    total = -(-K // stage_rows)
    partial_us = 8 * G * M * N / kernel_lib.DW_PARTIAL_BYTES_PER_US
    max_p = max(1, MAX_SCRATCH_BYTES // (4 * G * M * N))
    best, spb_seen = None, set()
    for P in range(1, min(total, max_p) + 1):
        spb = -(-total // P)
        if spb in spb_seen:
            continue
        spb_seen.add(spb)
        P = -(-total // spb)
        waves = -(-(P * tiles * G) // slots)
        runs = -(-spb // kernel_lib.DW_MAX_STAGES)
        cost = waves * (spb * stage_us + block_us + (runs - 1) * run_us) + (P * partial_us if P > 1 else 0.0)
        if best is None or cost < best[0]:
            best = (cost, dict(variant=variant, tile=tile, tiles=tiles, P=P, stages=spb, rows=spb * stage_rows,
                               grid=(tiles, P, G), waves=waves, smem=smem,
                               scratch_bytes=4 * G * P * M * N if P > 1 else 0))
    return best[1]


# ---------------------------------------------------------------------------
# Plain PyTorch version (the reference of the tests)
# ---------------------------------------------------------------------------


def reduce_plain(partials):
    """partials (G, P, M, N) -> (G, M, N) in the reduction kernel's order:
    row r of REDUCE_ROWS sums p = r, r + REDUCE_ROWS, ... in order, then the
    rows' sums are added in order."""
    rows = []
    for r in range(REDUCE_ROWS):
        s = torch.zeros_like(partials[:, 0])
        for p in range(r, partials.shape[1], REDUCE_ROWS):
            s = s + partials[:, p]
        rows.append(s)
    out = rows[0]
    for s in rows[1:]:
        out = out + s
    return out


def grouped_dw_plain(x, dy, tiling: dict):
    """The kernels' split and sum at a tiling, plainly: K cut into shares of
    `rows` rows (the last ragged), dW into tiles of `tile` (x and dy
    zero-padded past M and N, the tiles' rows and columns past them
    dropped), each share summed into a partial, the partials summed as the
    reduction kernel sums them (`reduce_plain`). Returns (partials (G, P, M,
    N), dW (G, M, N))."""
    G, K, M = x.shape
    N = dy.shape[-1]
    (bm, bn), rows = tiling["tile"], tiling["rows"]
    xp, yp = F.pad(x, (0, -M % bm)), F.pad(dy, (0, -N % bn))
    partials = []
    for k0 in range(0, K, rows):
        part = x.new_zeros((G, M, N))
        for m0 in range(0, M, bm):
            for n0 in range(0, N, bn):
                t = torch.bmm(xp[:, k0:k0 + rows, m0:m0 + bm].transpose(1, 2), yp[:, k0:k0 + rows, n0:n0 + bn])
                part[:, m0:m0 + bm, n0:n0 + bn] = t[:, : min(bm, M - m0), : min(bn, N - n0)]
        partials.append(part)
    partials = torch.stack(partials, 1)
    return partials, reduce_plain(partials)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


def _library():
    """The kernel library (`kernel_lib.library`) with these kernels'
    functions declared and its sizes checked against this module's."""
    return kernel_lib.library(_declare)


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grouped_dw.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.grouped_dw_ffma.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
    lib.grouped_dw_reduce.argtypes = [p, p, i, i, i, p]
    lib.grouped_dw_ffma_smem.argtypes = [i, i]
    sizes = (lib.grouped_dw_max_run, lib.grouped_dw_ffma_rows, lib.grouped_dw_ffma_stages,
             lib.grouped_dw_reduce_rows)
    for fn in sizes:
        fn.argtypes = []
    for fn in (lib.grouped_dw, lib.grouped_dw_ffma, lib.grouped_dw_reduce, lib.grouped_dw_ffma_smem, *sizes):
        fn.restype = i
    if tuple(fn() for fn in sizes) != (kernel_lib.DW_MAX_STAGES, FFMA_ROWS, FFMA_STAGES, REDUCE_ROWS) or any(
            lib.grouped_dw_ffma_smem(*ffma_tile(M, N)) != ffma_smem(*ffma_tile(M, N))
            for M, N in ((15, 128), (128, 6), (64, 64), (4, 4), (1000, 1))):
        raise RuntimeError("kernel library sizes the grouped weight gradient otherwise")


def _dims(x, dy) -> tuple:
    if x.ndim != 3 or dy.ndim != 3 or x.shape[:2] != dy.shape[:2]:
        raise ValueError(f"x must be (G, K, M) and dy (G, K, N); got {tuple(x.shape)} and {tuple(dy.shape)}")
    G, K, M = x.shape
    N = dy.shape[-1]
    if min(G, K, M, N) < 1:
        raise ValueError(f"empty weight gradient: x {tuple(x.shape)}, dy {tuple(dy.shape)}")
    return G, K, M, N


def grouped_dw_cuda(x, dy):
    """The split-K kernel at `grouped_dw_tiling`'s launch: x (G, K, M), dy
    (G, K, N) -> partials (G, P, M, N), partials[g, p] the sum of x[g, k]^T
    dy[g, k] over block p's rows (P = 1: dW itself)."""
    G, K, M, N = _dims(x, dy)
    dev = x.device
    kernel_lib.check({"x": (x, (G, K, M)), "dy": (dy, (G, K, N))}, dev)
    lib = _library()
    tile = grouped_dw_tiling(G, K, M, N, kernel_lib.sms())
    P = tile["P"]
    partials = torch.empty((G, P, M, N), device=dev)
    args = (kernel_lib.ptr(x), kernel_lib.ptr(dy), kernel_lib.ptr(partials), G, K, M, N)
    if tile["variant"] == "wgmma":
        kernel, fn, args = "grouped_dw_kernel", lib.grouped_dw, (*args, P, tile["stages"])
    else:
        kernel, fn, args = "grouped_dw_ffma_kernel", lib.grouped_dw_ffma, (*args, *tile["tile"], P, tile["stages"])
    kernel_lib.launch(kernel, fn, args, LAUNCHES["dw"], {"partials": partials}, G=G, K=K, M=M, N=N)
    return partials


def grouped_dw_reduce_cuda(partials):
    """partials (G, P, M, N) -> (G, M, N), summed over P in order (two calls
    give bitwise-equal results)."""
    if partials.ndim != 4:
        raise ValueError(f"partials must be (G, P, M, N); got {tuple(partials.shape)}")
    G, P, M, N = partials.shape
    dev = partials.device
    kernel_lib.check({"partials": (partials, (G, P, M, N))}, dev)
    out = torch.empty((G, M, N), device=dev)
    kernel_lib.launch("grouped_dw_reduce_kernel", _library().grouped_dw_reduce,
                      (kernel_lib.ptr(partials), kernel_lib.ptr(out), G, P, M * N), LAUNCHES["reduce"], {"out": out},
                      G=G, P=P, E=M * N)
    return out


def weight_gradient(x, dy):
    """dW = x^T dy over K, (G, M, N), of the f32 product's backward on
    CUDA tensors x (G, K, M) and dy (G, K, N): the kernels where `dw_route`
    sends the shape, else cuBLAS (`torch.bmm`). Counted as `("linear/dw",
    route, (G, K, M, N))`, inside the span `linear/dw`."""
    G, K, M = x.shape
    N = dy.shape[-1]
    route = dw_route(G, K, M, N)
    profiling.count(("linear/dw", route, (G, K, M, N)))
    with profiling.span("linear/dw"):
        if route == "cublas":
            return torch.bmm(x.transpose(1, 2), dy)
        partials = grouped_dw_cuda(aligned(x), aligned(dy))
        return partials[:, 0] if partials.shape[1] == 1 else grouped_dw_reduce_cuda(partials)
