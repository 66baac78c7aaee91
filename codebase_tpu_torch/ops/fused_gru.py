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
  T*B rows of `h_prev` and `dgh = [dgi_r, dgi_z, dgh_n]`, on `wgmma` in
  3xTF32 with its rows brought in by TMA, in tiles of 128 x 192 of dW_hh,
  split over K into per-block partial sums (`dw_tiling`).
- `gru_reduce` (replaces the in-order `dW_hh`/`db_hh` accumulation of
  `_bwd_kernel`): sums those partials. On the TPU the accumulation into one
  output block is race-free because grid steps run in order; GPU blocks
  run in parallel, so each writes its own partial and this kernel reduces
  them, bound by bytes, in a fixed order (deterministic, no atomics).

At 256 <= H <= MAX_HIDDEN, W_hh (3 MB at H=512) does not fit in shared
memory, and two wide variants take the recurrences. Both stream W_hh
through a warp-private ring of shared-memory stages filled by `cp.async`
and read each stage once per block for a row tile of R rows.
`gru_fwd_wide`'s stages are 16-deep slices of one 128-unit chunk's r, z
and n columns, its row tile 16, 32 or 64 rows; at T=1 its grid also splits
the hidden units across blocks (`wide_forward_tiling`). `gru_bwd_wide`
forms `h_prev @ W_hh` from the same stages and `dgh @ W_hh^T` from stages
of W_hh's rows, one unit chunk of dgh at a time, so that it holds only
that chunk's dgh in shared memory; its row tile is 16 or 32 rows
(`wide_backward_tiling`). `gru_dw` and `gru_reduce` serve every H.

The header of `csrc/fused_gru.cu` says what bounds each kernel and what the
design does about it. The library is built and loaded by
`ops/kernel_lib.py`, which also holds the sizes (`DW_*`) of the weight
gradient's design, shared with `ops/grouped_dw.py`.

Dispatch: a CPU tensor goes through the plain PyTorch version
(`gru_sequence_plain`, a loop of GRU-cell tensor ops with autograd through
it); a CUDA tensor launches the kernels or raises. There is no fallback.
The backward's plain versions (`gru_bwd_plain`, `gru_dw_plain` and their
composition `gru_backward_plain`) are the references the kernels are held
to; no path runs them on a CUDA tensor.
Every tensor carries a leading group axis G (agents or sharing groups): one
launch covers all groups.

Launch counters (`launch_counts()`: `fwd`, `bwd`, `fwd_wide`, `bwd_wide`,
`dw`, `reduce`, entries `gru_launch/<kernel>` of `utils/profiling`'s counter
registry) rise by one where a kernel is launched and nowhere else, so a run
can show that its path went through the kernels. The recurrence's calls
are counted apart from its kernels, by direction and shape, so the count
stays whatever kernels implement it: `("gru/forward", (G, T, B, H))` at
each `fused_gru_sequence` call, `("gru/backward", (G, T, B, H))` at each
kernel backward; on the card each runs inside the span of the same name.
After each launch the wrapper hands the kernel's name, outputs and shape
to `kernel_lib.launched`: in a debug region (`utils/debug.py`) a NaN in an
output raises naming the kernel, and `utils/profiling.cost_analysis` counts
its operations and bytes by this module's `kernel_flops` and
`kernel_bytes`. No PyTorch tool sees these `ctypes` launches otherwise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from codebase_tpu_torch.ops import kernel_lib
from codebase_tpu_torch.ops.kernel_lib import (  # the weight gradient's sizes, shared with ops/grouped_dw.py
    DW_BLOCK_US, DW_CHUNK, DW_MAX_STAGES, DW_PARTIAL_BYTES_PER_US, DW_SMEM, DW_STAGE_US, DW_TILE_M, DW_TILE_N,
)
from codebase_tpu_torch.ops.matmul import grouped_linear
from codebase_tpu_torch.utils import profiling

# `launch_counts()`' keys and their counters in the registry
LAUNCHES = {k: f"gru_launch/{k}" for k in ("fwd", "bwd", "fwd_wide", "bwd_wide", "dw", "reduce")}

RESIDENT_HIDDEN = 128  # the hidden size of the kernels that hold W_hh in shared memory
MAX_HIDDEN = 896  # the wide kernels' largest H (csrc/fused_gru.cu kMaxH)

# the wide forward's shared memory (csrc/fused_gru.cu `wide_fwd_smem`): an
# h tile of `rows` rows at stride H + 16 floats (two when T > 1), and a ring
# of two W_hh stages of 8 warps' 16 x 48 columns at a stride of 52 floats;
# an H100 block can have 232,448 bytes. WIDE_STAGE_COST: a weight for the
# time of a block's stage at each row tile, fitted so that
# `wide_forward_tiling` picks the fastest tiling measured at every wide
# shape of chip_smoke.py on an H100 (`kernel_bench --tilings`, PERF.md).
WIDE_CHUNK = 128
WIDE_STAGES = 2
WIDE_STAGE_BYTES = 8 * 16 * 52 * 4
SMEM_PER_BLOCK = 232_448
WIDE_STAGE_COST = {16: 1.0, 32: 1.5, 64: 2.9}
# the wide backward's shared memory (`wide_bwd_smem`): the h_prev tile
# (stride H + 16), the dgh tile of one 128-unit chunk (stride 400) and the
# forward's ring. Both of its instances use more than 128 registers a
# thread, so an SM holds one block (checked against the CUDA runtime's
# count on the card). WIDE_BWD_COST: a weight for the time of a wave of
# blocks at each row tile, fitted so that `wide_backward_tiling` picks the
# fastest row tile measured at every wide shape of chip_smoke.py on an
# H100 (`kernel_bench --tilings`, PERF.md).
WIDE_BWD_DGH_STRIDE = 3 * WIDE_CHUNK + 16
WIDE_BWD_BLOCKS_PER_SM = 1
WIDE_BWD_COST = {16: 1.0, 32: 1.4}


def reset_launch_counts() -> None:
    profiling.reset_counters(LAUNCHES.values())


def launch_counts() -> dict:
    counts = profiling.counters()
    return {k: counts.get(name, 0) for k, name in LAUNCHES.items()}


def kernel_flops(kernel: str, dims: dict) -> float:
    """The operations of one launch at its shape: 2*M*N*K for each product
    over K = T*B rows (the forward's h @ W_hh; the recurrence's h_prev @ W_hh
    and dgh @ W_hh^T; the weight gradient's h_prev^T dgh), the reduction's
    adds. The tensor cores run each product three times in 3xTF32
    (`chip_smoke.py` `bounds()`)."""
    if kernel == "gru_reduce_kernel":
        return float(dims["G"] * (dims["P"] - 1) * dims["E"])
    G, T, B, H = (dims[k] for k in "GTBH")
    products = 2 if kernel.startswith("gru_bwd") else 1
    return float(products * 2 * G * T * B * H * 3 * H)


def kernel_bytes(kernel: str, dims: dict) -> float:
    """The f32 bytes one launch must move at its shape, each input read once
    and each output written once, no scratch or partials (the bytes of
    `chip_smoke.py` `bounds()`): the forward's gi, W_hh, b_hh, h0 -> y, hT;
    the recurrence's gi, W_hh, b_hh, h0, y, dy, dhT -> dgi, dh0, dgh_n; the
    weight gradient's h_prev, dgh -> dW_hh, db_hh; the reduction's P
    partials -> their sum. `gru_backward` is the three backward kernels as
    one function (`gru_backward_cuda`): gi, W_hh, b_hh, h0, y, dy, dhT ->
    dgi, dW_hh, db_hh, dh0."""
    if kernel == "gru_reduce_kernel":
        return float(4 * dims["G"] * (dims["P"] + 1) * dims["E"])
    G, T, B, H = (dims[k] for k in "GTBH")
    H3, K = 3 * H, T * B
    weights = H * H3 + H3
    if kernel in ("gru_fwd_kernel", "gru_fwd_wide_kernel"):
        elements = K * H3 + weights + B * H + K * H + B * H
    elif kernel in ("gru_bwd_kernel", "gru_bwd_wide_kernel"):
        elements = (K * H3 + weights + B * H + 2 * K * H + B * H) + (K * H3 + B * H + K * H)
    elif kernel == "gru_dw_kernel":
        elements = K * H + K * H3 + weights
    elif kernel == "gru_backward":
        elements = (K * H3 + weights + B * H + 2 * K * H + B * H) + (K * H3 + weights + B * H)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    return float(4 * G * elements)


kernel_lib.COSTS.update({k: (kernel_flops, kernel_bytes) for k in (
    "gru_fwd_kernel", "gru_bwd_kernel", "gru_fwd_wide_kernel", "gru_bwd_wide_kernel", "gru_dw_kernel",
    "gru_reduce_kernel")})


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
# The library's GRU functions
# ---------------------------------------------------------------------------


def _library():
    """The kernel library (`kernel_lib.library`) with the GRU kernels'
    functions declared and its sizes checked against this module's."""
    return kernel_lib.library(_declare)


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gru_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.gru_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.gru_fwd_wide.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.gru_fwd_wide_smem.argtypes = [i, i, i]
    lib.gru_bwd_wide.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.gru_bwd_wide_smem.argtypes = [i, i]
    lib.gru_bwd_wide_blocks_per_sm.argtypes = [i, i]
    lib.gru_dw.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.gru_reduce.argtypes = [p, p, i, i, i, p]
    lib.gru_dw_tiles.argtypes = [i]
    lib.gru_dw_stages.argtypes = [i, i]
    sizes = (lib.gru_max_hidden, lib.gru_fwd_rows, lib.gru_dw_chunk, lib.gru_dw_smem)
    for fn in (lib.gru_fwd, lib.gru_bwd, lib.gru_fwd_wide, lib.gru_fwd_wide_smem, lib.gru_bwd_wide,
               lib.gru_bwd_wide_smem, lib.gru_bwd_wide_blocks_per_sm, lib.gru_dw, lib.gru_reduce,
               lib.gru_dw_tiles, lib.gru_dw_stages, *sizes):
        fn.restype = i
    for fn in sizes:
        fn.argtypes = []
    if lib.gru_max_hidden() != MAX_HIDDEN:
        raise RuntimeError("fused GRU library was built for other hidden sizes")
    if any(lib.gru_fwd_wide_smem(T, MAX_HIDDEN, rows) != wide_forward_smem(T, MAX_HIDDEN, rows)
           for T in (1, 2) for rows in (16, 32, 64)):
        raise RuntimeError("fused GRU library sizes the wide forward's shared memory otherwise")
    if any(lib.gru_bwd_wide_smem(H, rows) != wide_backward_smem(H, rows)
           for H in (256, MAX_HIDDEN) for rows in WIDE_BWD_COST):
        raise RuntimeError("fused GRU library sizes the wide backward's shared memory otherwise")
    if (lib.gru_dw_chunk(), lib.gru_dw_smem()) != (DW_CHUNK, DW_SMEM) or any(
            lib.gru_dw_tiles(H) != dw_tiles(H) or lib.gru_dw_stages(T, B) != dw_stages(T, B)
            for H in (RESIDENT_HIDDEN, 384, MAX_HIDDEN) for T, B in ((1, 100), (121, 256), (9, 77))):
        raise RuntimeError("fused GRU library tiles the weight gradient otherwise")


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


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


def forward_blocks_per_group(G: int, B: int, rows: int) -> int:
    """Blocks per group of the persistent forward grid. A block holds W_hh
    (192 KB) in shared memory, so one fits on an SM: at most `sms // G` per
    group, each walking tiles of `rows` rows. Small tiles let a short batch
    (the update shape, G=2 B=1024: 128 tiles of 16) spread its serial chains
    over the card."""
    return max(1, min(-(-B // rows), kernel_lib.sms() // G))


def wide_forward_smem(T: int, H: int, rows: int) -> int:
    """Bytes of dynamic shared memory of the wide forward: the h tile(s) and
    the ring (csrc/fused_gru.cu `wide_fwd_smem`)."""
    return (2 if T > 1 else 1) * rows * (H + 16) * 4 + WIDE_STAGES * WIDE_STAGE_BYTES


def wide_forward_tiling(G: int, T: int, B: int, H: int, sms: int) -> dict:
    """The wide forward's launch for a shape on a card of `sms` SMs.

    rows: the row tile (16, 32 or 64), each block's share of the batch;
    every W_hh stage it copies and every B fragment it splits serves that
    many rows, so the L2 stream of a step is G * ceil(B / rows) * 12H^2
    bytes. units: H / 128 at T=1, where each block forms one 128-unit chunk
    (a single step needs no other block's h), else 1. Waves count one
    block an SM.

    The cost of a row tile is its waves of blocks times `WIDE_STAGE_COST`,
    a fitted weight for the time of a block's stage; among the tiles whose
    shared memory fits, the cheapest wins, the larger on a tie. Returns {rows,
    units, stages, smem, grid (x, y, z), waves}."""
    units = H // WIDE_CHUNK if T == 1 else 1
    best = None
    for rows in (64, 32, 16):
        smem = wide_forward_smem(T, H, rows)
        if smem > SMEM_PER_BLOCK:
            continue
        tiles = -(-B // rows)
        waves = -(-(tiles * units * G) // sms)
        cost = waves * WIDE_STAGE_COST[rows]
        if best is None or cost < best[0]:
            best = (cost, dict(rows=rows, units=units, stages=WIDE_STAGES, smem=smem, grid=(tiles, units, G),
                               waves=waves))
    if best is None:
        raise ValueError(f"no wide forward tiling fits shared memory at T={T} H={H}")
    return best[1]


def wide_backward_smem(H: int, rows: int) -> int:
    """Bytes of dynamic shared memory of the wide backward: the h_prev tile,
    one unit chunk's dgh tile and the ring (csrc/fused_gru.cu `wide_bwd_smem`)."""
    return rows * (H + 16 + WIDE_BWD_DGH_STRIDE) * 4 + WIDE_STAGES * WIDE_STAGE_BYTES


def wide_backward_tiling(G: int, T: int, B: int, H: int, sms: int) -> dict:
    """The wide backward's launch for a shape on a card of `sms` SMs.

    rows: the row tile (16 or 32), each block's share of the batch; every
    W_hh stage it copies serves that many rows, so the L2 stream of a step
    is G * ceil(B / rows) * 24H^2 bytes. blocks_per_sm: the blocks an SM
    holds at once (one: registers). waves: ceil(blocks / (sms *
    blocks_per_sm)).

    The cost of a row tile is its waves times `WIDE_BWD_COST`, a fitted
    weight for the time of a wave; among the tiles whose shared memory
    fits, the cheapest wins, the larger on a tie. T does not enter: every
    step needs the whole of h, so the units are never split. Returns
    {rows, grid (x, y), smem, blocks_per_sm, waves}."""
    best = None
    for rows in (32, 16):
        smem = wide_backward_smem(H, rows)
        if smem > SMEM_PER_BLOCK:
            continue
        tiles = -(-B // rows)
        waves = -(-(tiles * G) // (sms * WIDE_BWD_BLOCKS_PER_SM))
        cost = waves * WIDE_BWD_COST[rows]
        if best is None or cost < best[0]:
            best = (cost, dict(rows=rows, grid=(tiles, G), smem=smem, blocks_per_sm=WIDE_BWD_BLOCKS_PER_SM,
                               waves=waves))
    if best is None:
        raise ValueError(f"no wide backward tiling fits shared memory at H={H}")
    return best[1]


def gru_fwd_cuda(gi, w_hh, b_hh, h0, tiling=None):
    """Kernel 1, `gru_fwd` at H=128, `gru_fwd_wide` above:
    (y (G, T, B, H), hT (G, B, H)). `tiling` ({rows, units}) replaces
    `wide_forward_tiling`'s choice for the wide forward (for measurements)."""
    G, T, B, H = _dims(gi)
    dev = gi.device
    kernel_lib.check(
        {"gi": (gi, (G, T, B, 3 * H)), "w_hh": (w_hh, (G, H, 3 * H)),
         "b_hh": (b_hh, (G, 3 * H)), "h0": (h0, (G, B, H))},
        dev,
    )
    lib = _library()
    y = torch.empty((G, T, B, H), device=dev)
    hT = torch.empty((G, B, H), device=dev)
    args = (*map(kernel_lib.ptr, (gi, w_hh, b_hh, h0, y, hT)), G, T, B, H)
    wide = kernel_variant(H) == "wide"
    with torch.cuda.device(dev):
        if wide:
            tile = tiling or wide_forward_tiling(G, T, B, H, kernel_lib.sms())
            code = lib.gru_fwd_wide(*args, tile["rows"], tile["units"], kernel_lib.stream(dev))
        else:
            code = lib.gru_fwd(*args, forward_blocks_per_group(G, B, lib.gru_fwd_rows()), kernel_lib.stream(dev))
    kernel_lib.raise_on(code, "gru_fwd_wide launch" if wide else "gru_fwd launch")
    profiling.count(LAUNCHES["fwd_wide" if wide else "fwd"])
    kernel_lib.launched("gru_fwd_wide_kernel" if wide else "gru_fwd_kernel", {"y": y, "hT": hT},
                        G=G, T=T, B=B, H=H)
    return y, hT


def gru_bwd_cuda(gi, w_hh, b_hh, h0, y, dy, dhT, tiling=None):
    """Kernel 2, the reverse-time recurrence (`gru_bwd` on the forward's
    persistent grid at H=128, `gru_bwd_wide` above): (dgi (G, T, B, 3H),
    dh0 (G, B, H), dgh_n (G, T, B, H)). `tiling` ({rows}) replaces
    `wide_backward_tiling`'s choice for the wide backward (for measurements)."""
    G, T, B, H = _dims(gi)
    dev = gi.device
    kernel_lib.check(
        {"gi": (gi, (G, T, B, 3 * H)), "w_hh": (w_hh, (G, H, 3 * H)),
         "b_hh": (b_hh, (G, 3 * H)), "h0": (h0, (G, B, H)), "y": (y, (G, T, B, H)),
         "dy": (dy, (G, T, B, H)), "dhT": (dhT, (G, B, H))},
        dev,
    )
    lib = _library()
    dgi = torch.empty_like(gi)
    dh0 = torch.empty_like(h0)
    dgh_n = torch.empty_like(y)
    args = (*map(kernel_lib.ptr, (gi, w_hh, b_hh, h0, y, dy, dhT, dgi, dh0, dgh_n)), G, T, B, H)
    wide = kernel_variant(H) == "wide"
    with torch.cuda.device(dev):
        if wide:
            tile = tiling or wide_backward_tiling(G, T, B, H, kernel_lib.sms())
            code = lib.gru_bwd_wide(*args, tile["rows"], kernel_lib.stream(dev))
        else:
            code = lib.gru_bwd(*args, forward_blocks_per_group(G, B, lib.gru_fwd_rows()), kernel_lib.stream(dev))
    kernel_lib.raise_on(code, "gru_bwd_wide launch" if wide else "gru_bwd launch")
    profiling.count(LAUNCHES["bwd_wide" if wide else "bwd"])
    kernel_lib.launched("gru_bwd_wide_kernel" if wide else "gru_bwd_kernel",
                        {"dgi": dgi, "dh0": dh0, "dgh_n": dgh_n}, G=G, T=T, B=B, H=H)
    return dgi, dh0, dgh_n


def dw_tiles(H: int) -> int:
    """Tiles of DW_TILE_M x DW_TILE_N that cover dW_hh (H x 3H)."""
    return (H // DW_TILE_M) * (3 * H // DW_TILE_N)


def dw_stages(T: int, B: int) -> int:
    """The weight gradient's stages of DW_CHUNK rows over K = T*B: those of
    h0's B rows, then those of y's first (T - 1) * B (csrc/fused_gru.cu
    `gru_dw_stages`; the last stage of each is ragged)."""
    return -(-B // DW_CHUNK) + -(-(T - 1) * B // DW_CHUNK)


@functools.lru_cache(maxsize=256)
def dw_tiling(G: int, T: int, B: int, H: int, sms: int) -> dict:
    """The weight gradient's launch for a shape on a card of `sms` SMs.

    Each block forms one DW_TILE_M x DW_TILE_N tile of dW_hh[g] over `stages`
    consecutive stages of DW_CHUNK rows, and P blocks share a tile's stages.
    The cost of a split is its waves of blocks (one an SM) times a block's
    time, `stages` * DW_STAGE_US + DW_BLOCK_US, plus the P partials written
    and read again by the reduction (2 * 4 * G * (H*3H + 3H) bytes each at
    DW_PARTIAL_BYTES_PER_US); the cheapest P wins, the smaller on a tie, so
    the blocks fill whole waves where the stages allow. Returns {tile, tiles,
    P, stages, rows (stages * DW_CHUNK), grid (tiles, P, G), waves, fill
    (blocks over waves * sms), smem}."""
    tiles = dw_tiles(H)
    total = dw_stages(T, B)
    partial_us = 8 * G * (H * 3 * H + 3 * H) / DW_PARTIAL_BYTES_PER_US
    best, spb_seen = None, set()
    for P in range(-(-total // DW_MAX_STAGES), min(total, 8 * sms + total // DW_MAX_STAGES) + 1):
        spb = -(-total // P)
        if spb in spb_seen:
            continue
        spb_seen.add(spb)
        P = -(-total // spb)
        blocks = P * tiles * G
        waves = -(-blocks // sms)
        cost = waves * (spb * DW_STAGE_US + DW_BLOCK_US) + P * partial_us
        if best is None or cost < best[0]:
            best = (cost, dict(tile=(DW_TILE_M, DW_TILE_N), tiles=tiles, P=P, stages=spb, rows=spb * DW_CHUNK,
                               grid=(tiles, P, G), waves=waves, fill=blocks / (waves * sms), smem=DW_SMEM))
    return best[1]


def gru_dw_cuda(h0, y, dgi, dgh_n, stages=None):
    """Kernel 3, dW_hh and db_hh over K = T*B rows: partials (G, P, H*3H + 3H),
    where partials[g, p] holds the share of rows block p summed of
    [dW_hh[g] | db_hh[g]]. `stages` (a block's stages) replaces `dw_tiling`'s
    choice (for measurements)."""
    G, T, B, H = _dims(dgi)
    dev = dgi.device
    kernel_lib.check(
        {"h0": (h0, (G, B, H)), "y": (y, (G, T, B, H)), "dgi": (dgi, (G, T, B, 3 * H)),
         "dgh_n": (dgh_n, (G, T, B, H))},
        dev,
    )
    lib = _library()
    spb = stages or dw_tiling(G, T, B, H, kernel_lib.sms())["stages"]
    P, rows = -(-dw_stages(T, B) // spb), spb * DW_CHUNK
    partials = torch.empty((G, P, H * 3 * H + 3 * H), device=dev)
    with torch.cuda.device(dev):
        code = lib.gru_dw(
            *map(kernel_lib.ptr, (h0, y, dgi, dgh_n, partials)), G, T, B, H, P, rows, kernel_lib.stream(dev),
        )
    kernel_lib.raise_on(code, "gru_dw launch")
    profiling.count(LAUNCHES["dw"])
    kernel_lib.launched("gru_dw_kernel", {"partials": partials}, G=G, T=T, B=B, H=H)
    return partials


def reduce_partials_cuda(partials):
    """Kernel 4: partials (G, P, E) -> (G, E), summed over P in order (two
    calls give bitwise-equal results)."""
    if partials.ndim != 3:
        raise ValueError(f"partials must be (G, P, E); got {tuple(partials.shape)}")
    G, P, E = partials.shape
    dev = partials.device
    kernel_lib.check({"partials": (partials, (G, P, E))}, dev)
    lib = _library()
    out = torch.empty((G, E), device=dev)
    with torch.cuda.device(dev):
        code = lib.gru_reduce(kernel_lib.ptr(partials), kernel_lib.ptr(out), G, P, E, kernel_lib.stream(dev))
    kernel_lib.raise_on(code, "gru_reduce launch")
    profiling.count(LAUNCHES["reduce"])
    kernel_lib.launched("gru_reduce_kernel", {"out": out}, G=G, P=P, E=E)
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
        with profiling.span("gru/forward"):
            y, hT = gru_fwd_cuda(gi, w_hh, b_hh, h0)
        ctx.save_for_backward(gi, w_hh, b_hh, h0, y)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        gi, w_hh, b_hh, h0, y = ctx.saved_tensors
        profiling.count(("gru/backward", _shape(gi)))
        with profiling.span("gru/backward"):
            return gru_backward_cuda(gi, w_hh, b_hh, h0, y, dy.contiguous(), dhT.contiguous())


def _shape(gi) -> tuple:
    """(G, T, B, H) of the recurrence's input gi (G, T, B, 3H)."""
    G, T, B, H3 = gi.shape
    return G, T, B, H3 // 3


def fused_gru_sequence(gi, w_hh, b_hh, h0):
    """GRU recurrence over a whole sequence with a leading group axis.

    gi (G, T, B, 3H) = x @ w_ih + b_ih, w_hh (G, H, 3H), b_hh (G, 3H),
    h0 (G, B, H) -> (y (G, T, B, H), hT (G, B, H)). Differentiable. CPU
    tensors take the plain version; CUDA tensors the kernels. Each call
    counts as `("gru/forward", (G, T, B, H))`."""
    if gi.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_gru_sequence runs on cpu or cuda tensors; got {gi.device}")
    profiling.count(("gru/forward", _shape(gi)))
    if gi.device.type == "cpu":
        return gru_sequence_plain(gi, w_hh, b_hh, h0)
    return FusedGRUSequence.apply(gi, w_hh, b_hh, h0)


def gru_layer_sequence(params, x, h0, compute_dtype: str = "float32"):
    """Full GRU layer: the input projection as one matmul (bf16 inputs and
    an f32 result under `compute_dtype="bfloat16"`, as the JAX package's
    layer), then the fused recurrence, in f32 at every dtype.
    params {w_ih (G, in, 3H), w_hh, b_ih (G, 3H), b_hh},
    x (G, T, B, in), h0 (G, B, H) -> (y (G, T, B, H), hT (G, B, H))."""
    gi = grouped_linear(x, params["w_ih"], params["b_ih"], compute_dtype)
    return fused_gru_sequence(gi, params["w_hh"], params["b_hh"], h0.contiguous())
