"""The port's GRU recurrence (plain version, CPU) against the JAX package's
Pallas kernel run in interpret mode, as `tests/test_fused_gru.py` runs it.

Inputs come from a numpy seed and are handed to both sides; GRU layer
weights come from the JAX `gru_layer_init` and cross with `params_from_numpy`.
Tolerances are the JAX tests' own: 1e-5 for values, 2e-4 for gradients.
The CUDA kernels form every product (`h @ W_hh` in the forward;
`h_prev @ W_hh`, `dgh @ W_hh^T` and `h_prev^T dgh` in the backward) in
3xTF32 on tensor cores; that rounding is emulated here with integer bit
ops, so the precision scheme is held to the JAX kernel before any card run.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codebase_tpu.models.networks import gru_layer_init as jax_gru_layer_init
from codebase_tpu.ops import fused_gru as jfg
from codebase_tpu_torch.ops import fused_gru as fg
from codebase_tpu_torch.ops import kernel_lib
from codebase_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(2)
H = 128
_BMM = torch.bmm


def _inputs(G, T, B, seed=0, hidden=H):
    rng = np.random.default_rng(seed)
    gi = rng.standard_normal((G, T, B, 3 * hidden)).astype(np.float32)
    w_hh = (rng.standard_normal((G, hidden, 3 * hidden)) * 0.1).astype(np.float32)
    b_hh = (rng.standard_normal((G, 3 * hidden)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((G, B, hidden)).astype(np.float32)
    kw = rng.standard_normal((G, B, hidden)).astype(np.float32)
    return gi, w_hh, b_hh, h0, kw


def _jax_fused(gi, w_hh, b_hh, h0):
    """The JAX kernel (interpret mode) over a leading group axis."""
    return jax.vmap(lambda a, b, c, d: jfg.fused_gru_sequence(a, b, c, d, True))(gi, w_hh, b_hh, h0)


def _loss_jax(gi, w_hh, b_hh, h0, kw):
    y, hT = _jax_fused(gi, w_hh, b_hh, h0)
    return jnp.sum(y * y[:, ::-1]) * 1e-2 + jnp.sum(hT * kw)


def _loss_torch(gi, w_hh, b_hh, h0, kw):
    y, hT = fg.fused_gru_sequence(gi, w_hh, b_hh, h0)
    return (y * torch.flip(y, [1])).sum() * 1e-2 + (hT * kw).sum()


@pytest.mark.parametrize("G,B", [(1, 24), (1, 40), (3, 24)])
def test_values_and_grads_match_pallas_interpret(G, B):
    """G=1 is the JAX function itself; G=3 holds the group axis against
    `jax.vmap` of it."""
    arrays = _inputs(G, 7, B)
    y_ref, hT_ref = _jax_fused(*map(jnp.asarray, arrays[:4]))
    t = [torch.tensor(a, requires_grad=True) for a in arrays[:4]]
    y, hT = fg.fused_gru_sequence(*t)
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hT.detach().numpy(), hT_ref, rtol=1e-5, atol=1e-5)

    ref_grads = jax.grad(_loss_jax, argnums=(0, 1, 2, 3))(*map(jnp.asarray, arrays))
    grads = torch.autograd.grad(_loss_torch(*t, torch.tensor(arrays[4])), t)
    for g, r, name in zip(grads, ref_grads, ["dgi", "dw_hh", "db_hh", "dh0"]):
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=2e-4, err_msg=name)


def test_gru_layer_sequence_matches_jax():
    G, T, B = 2, 6, 16
    keys = jax.random.split(jax.random.PRNGKey(3), G)
    jparams = jax.vmap(lambda k: jax_gru_layer_init(k, H, H))(keys)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((G, T, B, H)).astype(np.float32)
    h0 = rng.standard_normal((G, B, H)).astype(np.float32)
    y_ref, hT_ref = jax.vmap(lambda p, xx, hh: jfg.gru_layer_sequence(p, xx, hh, interpret=True))(
        jparams, jnp.asarray(x), jnp.asarray(h0)
    )
    params = params_from_numpy(jax.device_get(jparams))
    y, hT = fg.gru_layer_sequence(params, torch.tensor(x), torch.tensor(h0))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), hT_ref, rtol=1e-5, atol=1e-5)


def test_cpu_call_never_touches_the_kernel_library(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the kernel library was touched on a CPU call")

    monkeypatch.setattr(fg, "_library", boom)
    monkeypatch.setattr(kernel_lib, "build_library", boom)
    monkeypatch.setattr(fg, "FusedGRUSequence", boom)
    before = fg.launch_counts()
    t = [torch.tensor(a, requires_grad=True) for a in _inputs(2, 3, 8)[:4]]
    y, hT = fg.fused_gru_sequence(*t)
    torch.autograd.grad((y.sum() + hT.sum()), t)
    assert fg.launch_counts() == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the CUDA wrappers raise on what the kernels do not take,
    before any build or launch."""
    gi, w_hh, b_hh, h0, _ = (torch.tensor(a) for a in _inputs(1, 2, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fg.gru_fwd_cuda(gi, w_hh, b_hh, h0)
    # the kernels take H % 128 == 0 up to MAX_HIDDEN, as the TPU kernel
    for hidden in (32, 192, fg.MAX_HIDDEN + 128):
        gi_h, w_h, b_h, h0_h, _ = (torch.tensor(a) for a in _inputs(1, 2, 4, hidden=hidden))
        with pytest.raises(ValueError, match=r"H % 128 == 0 up to H=896"):
            fg.gru_fwd_cuda(gi_h, w_h, b_h, h0_h)
    assert [fg.kernel_variant(h) for h in (64, 128, 256, 384, 512, 896, 1024)] == [
        None, "resident", "wide", "wide", "wide", "wide", None]
    with pytest.raises(ValueError, match="cpu or cuda"):
        fg.fused_gru_sequence(gi.to("meta"), w_hh.to("meta"), b_hh.to("meta"), h0.to("meta"))


def _tf32(x):
    """f32 -> TF32 (10 mantissa bits) rounded to nearest, ties away from
    zero, with integer bit ops: what `cvt.rna.tf32.f32` does on the card."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """f32 -> TF32 by dropping the 13 low bits: what the tensor core reads
    of an f32 register it is given as a TF32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _bmm_3xtf32(a, b):
    """`torch.bmm` as the kernels form it: each operand split into
    big = tf32(x) and small = x - big (read as TF32 by truncation), then
    small*big + big*small + big*big summed in f32 (each product of two TF32
    values is exact in f32)."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32_truncated(a - a_big), _tf32_truncated(b - b_big)
    return _BMM(a_small, b_big) + _BMM(a_big, b_small) + _BMM(a_big, b_big)


@functools.lru_cache(maxsize=1)
def _update_shape_case():
    """Inputs at G=2, T=26 (the update shape's length), B=64, and the JAX
    kernel's outputs on them."""
    arrays = _inputs(2, 26, 64, seed=7)
    y_ref, hT_ref = _jax_fused(*map(jnp.asarray, arrays[:4]))
    return arrays, np.asarray(y_ref), np.asarray(hT_ref)


@pytest.mark.parametrize("product", ["3xtf32", "tf32"])
def test_tf32_products_in_the_plain_recurrence_against_pallas_interpret(monkeypatch, product):
    """The port's plain recurrence with every `h @ W_hh` formed on TF32
    operands, against the JAX kernel over 26 steps. In 3xTF32 it stays within
    the 1e-5 that chip_smoke.py holds the forward kernel to; single-pass TF32
    (about three decimal digits) does not, which is why the kernel pays for
    three products."""
    arrays, y_ref, hT_ref = _update_shape_case()
    bmm = _bmm_3xtf32 if product == "3xtf32" else (lambda a, b: _BMM(_tf32(a), _tf32(b)))
    monkeypatch.setattr(torch, "bmm", bmm)
    with torch.no_grad():
        y, hT = fg.gru_sequence_plain(*(torch.tensor(a) for a in arrays[:4]))
    if product == "3xtf32":
        np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(hT.numpy(), hT_ref, rtol=1e-5, atol=1e-5)
    else:
        assert not np.allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)


def test_tf32_rounding_helper_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-12, -1.0 - 2.0**-11, 3.0e-3])
    got = _tf32(x)
    assert got[:5].tolist() == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0 + 2.0**-10, -1.0 - 2.0**-10]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert _tf32_truncated(x)[:5].tolist() == [1.0, 1.0 + 2.0**-10, 1.0, 1.0, -1.0]
    assert abs(got[5].item() - 3.0e-3) <= 3.0e-3 * 2.0**-11


def test_forward_grid_fills_the_card(monkeypatch):
    """One block per SM holds W_hh, and no more blocks than 16-row tiles:
    the rollout shape walks 62 tiles a block, the update shape one."""
    monkeypatch.setattr(kernel_lib, "sms", lambda: 132)
    assert fg.forward_blocks_per_group(2, 65536, 16) == 66
    assert fg.forward_blocks_per_group(2, 1024, 16) == 64
    assert fg.forward_blocks_per_group(3, 1000, 16) == 44
    assert fg.forward_blocks_per_group(1, 5, 16) == 1
    assert fg.forward_blocks_per_group(5, 65536, 16) == 26
    assert fg.forward_blocks_per_group(200, 64, 16) == 1


# the wide kernels' shapes on the MMM2 paths and the ragged checks
# (chip_smoke.py (p)-(x)): (G, T, B, H)
WIDE_SHAPES = {
    "p": (10, 1, 2048, 512), "q": (10, 121, 256, 512), "r": (10, 1, 100, 512), "s": (10, 1, 256, 512),
    "t": (10, 120, 256, 512), "u": (10, 121, 256, 512), "v": (3, 7, 1000, 256), "w": (3, 5, 333, 384),
    "x": (2, 9, 77, 896),
}
WIDE_HIDDEN = range(256, fg.MAX_HIDDEN + 1, 128)


@pytest.mark.parametrize("hidden", WIDE_HIDDEN)
def test_wide_forward_tiling_fits_shared_memory(hidden):
    """At every wide H and every (G, T, B) of (p)-(x), on 132 SMs: the
    shared memory asked for is the kernel's (h tiles and a ring of two
    26 KB W_hh stages) and fits a block's 227 KB."""
    for G, T, B, _ in WIDE_SHAPES.values():
        tile = fg.wide_forward_tiling(G, T, B, hidden, 132)
        assert tile["rows"] in (16, 32, 64) and tile["stages"] == 2
        assert tile["smem"] == fg.wide_forward_smem(T, hidden, tile["rows"])
        assert tile["smem"] == ((2 if T > 1 else 1) * tile["rows"] * (hidden + 16) + 2 * 16 * 52 * 8) * 4
        assert tile["smem"] <= fg.SMEM_PER_BLOCK == 232_448


def _coverage(G, T, B, H, tile):
    """How often the launch's blocks form each (group, row, unit)."""
    seen = np.zeros((G, B, H), dtype=np.int64)
    nx, ny, nz = tile["grid"]
    assert nz == G and ny == tile["units"]
    chunk = H // ny
    for x in range(nx):
        for y in range(ny):
            seen[:, x * tile["rows"] : (x + 1) * tile["rows"], y * chunk : (y + 1) * chunk] += 1
    return seen


@pytest.mark.parametrize("G,T,B,hidden", [*WIDE_SHAPES.values(), (1, 1, 1000, 512), (2, 9, 77, 640), (1, 1, 1, 256),
                                          (3, 1, 65, 896), (1, 2, 33, 768)])
def test_wide_forward_tiles_cover_every_row_and_unit_once(G, T, B, hidden):
    """The grid's row tiles and unit chunks form every (group, row, unit)
    exactly once, B a multiple of the row tile or not (the kernel masks the
    rows past B); a unit chunk is 128 units."""
    tile = fg.wide_forward_tiling(G, T, B, hidden, 132)
    assert (tile["grid"][0] - 1) * tile["rows"] < B <= tile["grid"][0] * tile["rows"]
    assert hidden // tile["units"] in (128, hidden)
    assert (_coverage(G, T, B, hidden, tile) == 1).all()


@pytest.mark.parametrize("T", [1, 2, 26, 121])
def test_wide_forward_splits_units_only_at_one_step(T):
    """At T=1 a block forms one 128-unit chunk (H / 128 blocks a row tile);
    over several steps each block needs the whole of h every step, so it
    forms every unit."""
    for hidden in WIDE_HIDDEN:
        tile = fg.wide_forward_tiling(10, T, 256, hidden, 132)
        assert tile["units"] == (hidden // 128 if T == 1 else 1)


def test_wide_forward_tiling_fills_the_card():
    """At the MMM2 update (q) 32-row tiles run in one wave (80 blocks on 132
    SMs; 16-row tiles would need two), halving the W_hh stream of the
    16-row design; the rollout (p) takes 64-row tiles, the largest, over the
    unit split; H=896 leaves room for 16-row tiles only; the eval (r),
    MAPPO's rollout (s) and the ragged shapes take the tiling measured
    fastest there. Every shape of
    more than one step runs its row tiles' chains in one wave, on an H100
    SXM (132 SMs) and PCIe (114)."""
    q = fg.wide_forward_tiling(*WIDE_SHAPES["q"], 132)
    assert (q["rows"], q["grid"], q["waves"]) == (32, (8, 1, 10), 1)
    p = fg.wide_forward_tiling(*WIDE_SHAPES["p"], 132)
    assert (p["rows"], p["grid"], p["units"]) == (64, (32, 4, 10), 4)
    x = fg.wide_forward_tiling(*WIDE_SHAPES["x"], 132)
    assert (x["rows"], x["grid"]) == (16, (5, 1, 2))
    # the fastest tiling measured on an H100 at the other shapes (PERF.md)
    chosen = {k: (t["rows"], t["units"]) for k, t in
              ((k, fg.wide_forward_tiling(*WIDE_SHAPES[k], 132)) for k in "rsvw")}
    assert chosen == {"r": (64, 4), "s": (32, 4), "v": (32, 1), "w": (16, 1)}
    for sms in (132, 114):
        for key, (G, T, B, hidden) in WIDE_SHAPES.items():
            tile = fg.wide_forward_tiling(G, T, B, hidden, sms)
            blocks = tile["grid"][0] * tile["grid"][1] * tile["grid"][2]
            assert tile["waves"] == -(-blocks // sms), key
            if T > 1:
                assert tile["waves"] == 1, (key, sms)


@pytest.mark.parametrize("hidden", WIDE_HIDDEN)
def test_wide_backward_tiling_fits_shared_memory(hidden):
    """At every wide H and every (G, T, B) of (p)-(x), on 132 SMs: the
    shared memory asked for is the kernel's (the h_prev tile, one unit
    chunk's dgh tile of 384 columns at a stride of 400, the forward's ring
    of two 26 KB stages) and fits a block's 227 KB; an SM holds one block.
    The dgh tile holds one unit chunk, not 3H, so both row tiles fit at
    every wide H."""
    for G, T, B, _ in WIDE_SHAPES.values():
        tile = fg.wide_backward_tiling(G, T, B, hidden, 132)
        rows = tile["rows"]
        assert rows in (16, 32)
        assert tile["smem"] == fg.wide_backward_smem(hidden, rows)
        assert tile["smem"] == (rows * (hidden + 16) + rows * 400 + 2 * 16 * 52 * 8) * 4
        assert tile["smem"] <= fg.SMEM_PER_BLOCK == 232_448
        assert tile["blocks_per_sm"] == 1
    assert fg.wide_backward_smem(hidden, 32) <= fg.SMEM_PER_BLOCK


@pytest.mark.parametrize("G,T,B,hidden", [*WIDE_SHAPES.values(), (1, 1, 1000, 512), (2, 9, 77, 640), (1, 1, 1, 256),
                                          (3, 1, 65, 896), (1, 2, 33, 768), (10, 2, 40, 896)])
def test_wide_backward_tiles_cover_every_row_once(G, T, B, hidden):
    """The grid's row tiles form every (group, row) exactly once, B a
    multiple of the row tile or not (the kernel masks the rows past B);
    every block forms all H units."""
    tile = fg.wide_backward_tiling(G, T, B, hidden, 132)
    nx, nz = tile["grid"]
    assert nz == G and (nx - 1) * tile["rows"] < B <= nx * tile["rows"]
    seen = np.zeros((G, B), dtype=np.int64)
    for x in range(nx):
        seen[:, x * tile["rows"] : (x + 1) * tile["rows"]] += 1
    assert (seen == 1).all()


def test_wide_backward_tiling_fills_the_card():
    """At the MMM2 updates (q) and (t) the backward runs 80 blocks of 32
    rows in one wave on an H100 SXM (132 SMs) and PCIe (114); 16-row tiles
    would need two. Where 16-row tiles run in one wave ((r), (w), (x)),
    they take them: each block's chain is shorter. The choice at every
    shape is the row tile measured fastest there (PERF.md)."""
    for sms in (132, 114):
        for key in "qt":
            tile = fg.wide_backward_tiling(*WIDE_SHAPES[key], sms)
            assert (tile["rows"], tile["grid"], tile["waves"]) == (32, (8, 10), 1), (key, sms)
        for key, (G, T, B, hidden) in WIDE_SHAPES.items():
            tile = fg.wide_backward_tiling(G, T, B, hidden, sms)
            blocks = tile["grid"][0] * tile["grid"][1]
            assert tile["waves"] == -(-blocks // (sms * tile["blocks_per_sm"])), key
    chosen = {k: fg.wide_backward_tiling(*WIDE_SHAPES[k], 132)["rows"] for k in WIDE_SHAPES}
    assert chosen == {"p": 32, "q": 32, "r": 16, "s": 32, "t": 32, "u": 32, "v": 32, "w": 16, "x": 16}


def test_reduce_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match=r"\(G, P, E\)"):
        fg.reduce_partials_cuda(torch.zeros((2, 7)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fg.reduce_partials_cuda(torch.zeros((2, 3, 7)))


def test_reduce_partials_plain_is_the_sum_over_blocks():
    p = torch.tensor(np.random.default_rng(5).standard_normal((2, 5, 7)).astype(np.float32))
    np.testing.assert_allclose(fg.reduce_partials_plain(p).numpy(), p.numpy().sum(1), rtol=1e-6)


@functools.lru_cache(maxsize=4)
def _backward_case(G, T, B, seed, hidden=H):
    """Inputs of the backward (y from the JAX forward) and the JAX backward
    kernel's outputs (dgi, dW_hh, db_hh, dh0) on them, in interpret mode."""
    rng = np.random.default_rng(seed)
    gi, w_hh, b_hh, h0, _ = _inputs(G, T, B, seed, hidden)
    dy = rng.standard_normal((G, T, B, hidden)).astype(np.float32)
    dhT = rng.standard_normal((G, B, hidden)).astype(np.float32)
    y, _ = _jax_fused(*map(jnp.asarray, (gi, w_hh, b_hh, h0)))
    y = np.asarray(y)

    def bwd(gi_, w_, b_, h0_, y_, dy_, dhT_):
        return jfg._fused_gru_bwd(True, (gi_, w_, b_, h0_, y_), (dy_, dhT_))

    ref = jax.vmap(bwd)(*map(jnp.asarray, (gi, w_hh, b_hh, h0, y, dy, dhT)))
    return (gi, w_hh, b_hh, h0, y, dy, dhT), [np.asarray(r) for r in ref]


@pytest.mark.parametrize("G,B", [(1, 24), (1, 40), (3, 24), (3, 40)])
def test_backward_plain_matches_pallas_interpret_backward(G, B):
    """`gru_backward_plain` (the backward's plain version, the reference the
    kernels are held to on the card) against the JAX backward kernel,
    `jax.vmap`ped over groups, at the JAX tests' gradient tolerance."""
    arrays, ref = _backward_case(G, 7, B, 11)
    got = fg.gru_backward_plain(*(torch.tensor(a) for a in arrays))
    for g, r, name in zip(got, ref, ["dgi", "dw_hh", "db_hh", "dh0"]):
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("G,T,B", [(1, 7, 40), (3, 7, 24)])
def test_dw_plain_on_the_recurrence_outputs_matches_pallas_interpret(G, T, B):
    """The weight gradient as its own long-K product: `gru_dw_plain` fed the
    plain recurrence's dgi and dgh_n gives the JAX kernel's in-order dW_hh
    and db_hh within 1e-5 of their largest entry."""
    arrays, ref = _backward_case(G, T, B, 11)
    t = [torch.tensor(a) for a in arrays]
    dgi, _, dgh_n = fg.gru_bwd_plain(*t)
    dw, db = fg.gru_dw_plain(t[3], t[4], dgi, dgh_n)
    for g, r, name in ((dw, ref[1], "dw_hh"), (db, ref[2], "db_hh")):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(), err_msg=name)


def test_backward_in_3xtf32_against_pallas_interpret(monkeypatch):
    """The backward with all three products formed as the kernels form them
    (3xTF32), over 26 steps at B=64, against the JAX backward kernel: dgi and
    dh0 within 2e-4, dW_hh and db_hh within 1e-4 of their largest entry."""
    arrays, ref = _backward_case(2, 26, 64, 7)
    monkeypatch.setattr(torch, "bmm", _bmm_3xtf32)
    got = fg.gru_backward_plain(*(torch.tensor(a) for a in arrays))
    for g, r, name in zip(got, ref, ["dgi", "dw_hh", "db_hh", "dh0"]):
        if name in ("dgi", "dh0"):
            np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=2e-4, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=name)


def test_backward_wrappers_refuse_cpu_tensors():
    gi, w_hh, b_hh, h0, _ = (torch.tensor(a) for a in _inputs(1, 2, 4))
    y, dy = torch.zeros((1, 2, 4, H)), torch.zeros((1, 2, 4, H))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fg.gru_bwd_cuda(gi, w_hh, b_hh, h0, y, dy, h0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fg.gru_dw_cuda(h0, y, gi, y)
    with pytest.raises(ValueError, match=r"H % 128 == 0 up to H=896"):
        fg.gru_dw_cuda(h0[..., :32], y[..., :32], gi[..., :96], y[..., :32])


class _FakeLibrary:
    """Records the grid each launcher is given; launches nothing."""

    def __init__(self):
        self.calls = {}

    def gru_fwd_rows(self):
        return 16

    def gru_bwd(self, *args):
        self.calls["bwd"] = args[-2]
        return 0

    def gru_dw(self, *args):
        self.calls["dw"] = args[-3:-1]
        return 0

    def gru_fwd_wide(self, *args):
        self.calls["fwd_wide"] = args[-3:-1]
        return 0

    def gru_bwd_wide(self, *args):
        self.calls["bwd_wide"] = args[-2]
        return 0


@pytest.mark.parametrize("G,T,B", [(2, 26, 1024), (2, 1, 65536), (3, 7, 1000), (1, 3, 5), (200, 2, 64)])
def test_backward_grids_fill_the_card(monkeypatch, G, T, B):
    """The recurrence runs on the forward's persistent grid (one block per SM
    holds W_hh: 64 blocks of one 16-row tile per group at the update shape);
    the weight gradient splits its stages of 32 rows into P blocks of
    `rows` rows per tile of dW_hh (`dw_tiling`), every block with at least
    one stage, no more than DW_MAX_STAGES in one."""
    lib = _FakeLibrary()
    monkeypatch.setattr(kernel_lib, "sms", lambda: 132)
    monkeypatch.setattr(fg, "_library", lambda: lib)
    monkeypatch.setattr(kernel_lib, "check", lambda shapes, device: None)
    monkeypatch.setattr(kernel_lib, "stream", lambda device: None)
    monkeypatch.setattr(kernel_lib, "ptr", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    gi = torch.empty((G, T, B, 3 * H), device="meta")
    y, h0 = torch.empty((G, T, B, H), device="meta"), torch.empty((G, B, H), device="meta")
    w, b = torch.empty((G, H, 3 * H), device="meta"), torch.empty((G, 3 * H), device="meta")
    fg.gru_bwd_cuda(gi, w, b, h0, y, y, h0)
    partials = fg.gru_dw_cuda(h0, y, gi, y)
    assert lib.calls["bwd"] == fg.forward_blocks_per_group(G, B, 16)
    P, rows = lib.calls["dw"]
    stages = fg.dw_stages(T, B)
    assert partials.shape == (G, P, H * 3 * H + 3 * H)
    assert rows % 32 == 0 and (P - 1) * rows < 32 * stages <= P * rows <= 32 * (stages + P - 1)
    assert rows <= 32 * fg.DW_MAX_STAGES
    if (G, T, B) == (2, 26, 1024):
        assert (lib.calls["bwd"], P, rows) == (64, 32, 832)


@pytest.mark.parametrize("G,T,B,hidden", [WIDE_SHAPES["p"], WIDE_SHAPES["q"], WIDE_SHAPES["x"]])
def test_wide_forward_wrapper_launches_the_tiling(monkeypatch, G, T, B, hidden):
    """`gru_fwd_cuda` at a wide H hands the launcher the row tile and unit
    split of `wide_forward_tiling` for the card's SM count, or the tiling
    it is given; it counts one wide launch."""
    lib = _FakeLibrary()
    monkeypatch.setattr(kernel_lib, "sms", lambda: 132)
    monkeypatch.setattr(fg, "_library", lambda: lib)
    monkeypatch.setattr(kernel_lib, "check", lambda shapes, device: None)
    monkeypatch.setattr(kernel_lib, "stream", lambda device: None)
    monkeypatch.setattr(kernel_lib, "ptr", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    gi = torch.empty((G, T, B, 3 * hidden), device="meta")
    w, b = torch.empty((G, hidden, 3 * hidden), device="meta"), torch.empty((G, 3 * hidden), device="meta")
    h0 = torch.empty((G, B, hidden), device="meta")
    before = fg.launch_counts()
    y, hT = fg.gru_fwd_cuda(gi, w, b, h0)
    tile = fg.wide_forward_tiling(G, T, B, hidden, 132)
    assert lib.calls["fwd_wide"] == (tile["rows"], tile["units"])
    assert y.shape == (G, T, B, hidden) and hT.shape == (G, B, hidden)
    fg.gru_fwd_cuda(gi, w, b, h0, tiling=dict(rows=16, units=1))
    assert lib.calls["fwd_wide"] == (16, 1)
    after = fg.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {"fwd": 0, "bwd": 0, "fwd_wide": 2, "bwd_wide": 0,
                                                         "dw": 0, "reduce": 0}


@pytest.mark.parametrize("G,T,B,hidden", [WIDE_SHAPES["p"], WIDE_SHAPES["q"], WIDE_SHAPES["x"]])
def test_wide_backward_wrapper_launches_the_tiling(monkeypatch, G, T, B, hidden):
    """`gru_bwd_cuda` at a wide H hands the launcher the row tile of
    `wide_backward_tiling` for the card's SM count, or the tiling it is
    given; it counts one wide backward launch."""
    lib = _FakeLibrary()
    monkeypatch.setattr(kernel_lib, "sms", lambda: 132)
    monkeypatch.setattr(fg, "_library", lambda: lib)
    monkeypatch.setattr(kernel_lib, "check", lambda shapes, device: None)
    monkeypatch.setattr(kernel_lib, "stream", lambda device: None)
    monkeypatch.setattr(kernel_lib, "ptr", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    gi = torch.empty((G, T, B, 3 * hidden), device="meta")
    w, b = torch.empty((G, hidden, 3 * hidden), device="meta"), torch.empty((G, 3 * hidden), device="meta")
    y, h0 = torch.empty((G, T, B, hidden), device="meta"), torch.empty((G, B, hidden), device="meta")
    before = fg.launch_counts()
    dgi, dh0, dgh_n = fg.gru_bwd_cuda(gi, w, b, h0, y, y, h0)
    assert lib.calls["bwd_wide"] == fg.wide_backward_tiling(G, T, B, hidden, 132)["rows"]
    assert dgi.shape == gi.shape and dh0.shape == h0.shape and dgh_n.shape == y.shape
    fg.gru_bwd_cuda(gi, w, b, h0, y, y, h0, tiling=dict(rows=32))
    assert lib.calls["bwd_wide"] == 32
    after = fg.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {"fwd": 0, "bwd": 0, "fwd_wide": 0, "bwd_wide": 2,
                                                         "dw": 0, "reduce": 0}


# The wide kernels' W_hh stages as csrc/fused_gru.cu lays them out, a
# warp's part of a stage in 832 floats. The forward's (and the backward's
# gh) stage, `wide_stage_at`: 16 rows k of a 16-deep slice by 48 columns c
# (the warp's 16 units of r, z and n) at a stride of 52, bit 3 of c XORed
# with bit 3 of k; B fragments read as scalars, rows 4tig + i at column (j %
# 3) * 16 + (j // 3) * 8 + gid of n-tile j. The backward's dh stage,
# `dh_stage_at`: 16 rows u (the warp's 16 units of one unit chunk) by 48
# columns c (three 16-deep slices of the summed chunk's 384) at a stride of
# 48; B fragments read as float4, row 8u + gid, columns 16sl + 4tig .. + 3
# of slice sl.
def _wide_stage_at(k, c):
    return k * 52 + (c ^ (((k >> 3) & 1) << 3))


def _dh_stage_at(u, c):
    return u * 48 + c


STAGE_LAYOUTS = {"gh": (_wide_stage_at, 16, 48), "dh": (_dh_stage_at, 16, 48)}


def _stage_reads(layout):
    """Each warp-wide shared-memory read of a stage: a list of (lane,
    offset, width in floats) for the 32 lanes."""
    if layout == "gh":
        return [[(lane, _wide_stage_at(4 * (lane & 3) + i, (j % 3) * 16 + (j // 3) * 8 + (lane >> 2)), 1)
                 for lane in range(32)] for j in range(6) for i in range(4)]
    return [[(lane, _dh_stage_at(8 * u + (lane >> 2), 16 * sl + 4 * (lane & 3)), 4) for lane in range(32)]
            for u in range(2) for sl in range(3)]


@pytest.mark.parametrize("layout", ["gh", "dh"])
def test_wide_stage_layouts_are_in_range_contiguous_and_conflict_free(layout):
    """Each layout of a warp's part of a stage: the 768 floats copied land
    once each inside the 832-float part, each 16-byte copy on 4 contiguous
    floats (16-byte aligned); every fragment read finds a copied float, and
    is conflict-free: the 32 lanes of a scalar read on 32 banks, and each
    quarter-warp of a float4 read (8 lanes, 128 bytes) on 32 banks."""
    at, rows, cols = STAGE_LAYOUTS[layout]
    filled = {}
    for row in range(rows):
        for c in range(0, cols, 4):
            first = at(row, c)
            assert first % 4 == 0 and [at(row, c + e) for e in range(4)] == [first + e for e in range(4)]
            for e in range(4):
                assert 0 <= first + e < 16 * 52 and first + e not in filled
                filled[first + e] = (row, c + e)
    assert len(filled) == 16 * 48
    for read in _stage_reads(layout):
        assert all(off + e in filled for _, off, width in read for e in range(width))
        if read[0][2] == 1:
            assert len({off % 32 for _, off, _ in read}) == 32
        else:
            for q in range(4):
                phase = [off for lane, off, _ in read if lane // 8 == q]
                assert all(off % 4 == 0 for off in phase)
                assert sorted(b for off in phase for b in range(off % 32, off % 32 + 4)) == list(range(32))


@pytest.mark.parametrize("hidden,G,T,product", [(256, 3, 4, "f32"), (256, 3, 4, "3xtf32"),
                                                (512, 2, 3, "f32"), (512, 2, 3, "3xtf32")])
def test_wide_plain_forward_and_backward_match_pallas_interpret(monkeypatch, hidden, G, T, product):
    """The wide kernels' references at H=256 and 512 (B=16) against the JAX
    kernels in interpret mode, as formed in f32 and as the kernels form
    their products (3xTF32): y and hT within 1e-5, dgi and dh0 within 2e-4,
    dW_hh and db_hh within 1e-4 of their largest entry."""
    arrays, ref = _backward_case(G, T, 16, 17, hidden)
    gi, w_hh, b_hh, h0, y_ref, dy, dhT = (torch.tensor(a) for a in arrays)
    if product == "3xtf32":
        monkeypatch.setattr(torch, "bmm", _bmm_3xtf32)
    y, hT = fg.gru_sequence_plain(gi, w_hh, b_hh, h0)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), y_ref[:, -1].numpy(), rtol=1e-5, atol=1e-5)
    got = fg.gru_backward_plain(gi, w_hh, b_hh, h0, y_ref, dy, dhT)
    for g, r, name in zip(got, ref, ["dgi", "dw_hh", "db_hh", "dh0"]):
        if name in ("dgi", "dh0"):
            np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=2e-4, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("G,T,B,H_,P", [(10, 121, 256, 512, 9), (3, 7, 1000, 256, 5), (1, 3, 5, 384, 2),
                                        (2, 26, 1024, 128, 32), (10, 120, 256, 512, 9), (3, 60, 8192, 128, 132),
                                        (2, 9, 77, 896, 1)])
def test_weight_gradient_split_at_every_hidden_size(monkeypatch, G, T, B, H_, P):
    """`gru_dw` takes every H the kernels take: (H / 128) * (3H / 192) tiles
    of dW_hh. At the MMM2 updates (q), (t) the 320 tiles take P = 9 blocks of
    at most 108 stages each (22 waves, 99% full); at the SMAClite MAPPO
    update (j) 132 blocks a tile; at (x) the 196 tiles alone fill two waves.
    `stages` replaces the choice (for measurements)."""
    lib = _FakeLibrary()
    monkeypatch.setattr(kernel_lib, "sms", lambda: 132)
    monkeypatch.setattr(fg, "_library", lambda: lib)
    monkeypatch.setattr(kernel_lib, "check", lambda shapes, device: None)
    monkeypatch.setattr(kernel_lib, "stream", lambda device: None)
    monkeypatch.setattr(kernel_lib, "ptr", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    gi = torch.empty((G, T, B, 3 * H_), device="meta")
    y, h0 = torch.empty((G, T, B, H_), device="meta"), torch.empty((G, B, H_), device="meta")
    partials = fg.gru_dw_cuda(h0, y, gi, y)
    got_P, rows = lib.calls["dw"]
    stages = fg.dw_stages(T, B)
    assert got_P == P and partials.shape == (G, P, H_ * 3 * H_ + 3 * H_)
    assert rows == 32 * fg.dw_tiling(G, T, B, H_, 132)["stages"] and (P - 1) * rows < 32 * stages <= P * rows
    partials = fg.gru_dw_cuda(h0, y, gi, y, stages=1)
    assert lib.calls["dw"] == (stages, 32) and partials.shape[1] == stages


DW_HIDDEN = range(128, fg.MAX_HIDDEN + 1, 128)


@pytest.mark.parametrize("hidden", DW_HIDDEN)
def test_weight_gradient_tiles_cover_dw_once_and_fit_shared_memory(hidden):
    """At every H the kernels take: the tiles of 128 x 192 cover dW_hh (H x
    3H) once; the shared memory asked for (a ring of three 40 KB fp32
    stages, two pairs of 24 KB TF32 B buffers, the mbarriers and 1 KB of
    alignment slack) fits a block's 232,448 bytes, at every shape of
    chip_smoke.py."""
    tiles_n = 3 * hidden // fg.DW_TILE_N
    seen = np.zeros((hidden, 3 * hidden), dtype=np.int64)
    tiles = fg.dw_tiles(hidden)
    assert tiles == fg.dw_tiling(1, 2, 5, hidden, 132)["tiles"] == (hidden // 128) * (3 * hidden // 192)
    for t in range(tiles):
        m0, n0 = (t // tiles_n) * fg.DW_TILE_M, (t % tiles_n) * fg.DW_TILE_N
        seen[m0 : m0 + fg.DW_TILE_M, n0 : n0 + fg.DW_TILE_N] += 1
    assert (seen == 1).all()
    assert fg.DW_SMEM == 3 * 40_960 + 4 * 24_576 + 48 + 1024 <= fg.SMEM_PER_BLOCK == 232_448
    for G, T, B, _ in WIDE_SHAPES.values():
        assert fg.dw_tiling(G, T, B, hidden, 132)["smem"] == fg.DW_SMEM


def _dw_rows_of_stage(T, B, s):
    """The rows of K = T*B (h_prev's and dgh's) that stage s holds."""
    s_h0 = -(-B // 32)
    if s < s_h0:
        return range(32 * s, min(B, 32 * s + 32))
    r = 32 * (s - s_h0)
    return range(B + r, B + min((T - 1) * B, r + 32))


@pytest.mark.parametrize("G,T,B,hidden", [*WIDE_SHAPES.values(), (2, 26, 1024, 128), (2, 1, 65536, 128),
                                          (3, 61, 256, 128), (3, 60, 8192, 128), (2, 1, 100, 128), (1, 2, 33, 768),
                                          (1, 1, 1, 256)])
def test_weight_gradient_shares_cover_every_row_once(G, T, B, hidden):
    """The P blocks' shares of the stages, and the stages' rows, cover all
    T*B rows exactly once: h0's B rows, then y's first (T - 1) * B, each
    segment ending in a ragged stage (the tensor map's edge zero-fills the
    rest). No block is empty or sums more than DW_MAX_STAGES stages."""
    tile = fg.dw_tiling(G, T, B, hidden, 132)
    P, spb, total = tile["P"], tile["stages"], fg.dw_stages(T, B)
    assert tile["grid"] == (tile["tiles"], P, G) and 1 <= spb <= fg.DW_MAX_STAGES
    seen = np.zeros(T * B, dtype=np.int64)
    for p in range(P):
        block = range(p * spb, min(total, (p + 1) * spb))
        assert len(block) >= 1
        for s in block:
            seen[list(_dw_rows_of_stage(T, B, s))] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("sms", [132, 114])
def test_weight_gradient_grids_fill_whole_waves(sms):
    """Where the stages allow it, the K split fills whole waves: at every
    update shape of chip_smoke.py ((b), (d), (f), (i), (j), (l), (m), (q),
    (t), (u)) the last wave of blocks is at least 95% full on an H100 SXM
    (132 SMs) and PCIe (114), and the split is the cheapest under the cost
    model among all with at most DW_MAX_STAGES stages a block."""
    updates = [(2, 26, 1024, 128), (3, 26, 512, 128), (2, 25, 8192, 128), (3, 61, 256, 128), (3, 60, 8192, 128),
               (3, 61, 8192, 128), (2, 26, 8192, 128), WIDE_SHAPES["q"], WIDE_SHAPES["t"], WIDE_SHAPES["u"]]
    for G, T, B, hidden in updates:
        tile = fg.dw_tiling(G, T, B, hidden, sms)
        blocks = tile["P"] * tile["tiles"] * G
        assert tile["waves"] == -(-blocks // sms) and tile["fill"] == blocks / (tile["waves"] * sms)
        assert tile["fill"] >= 0.95, (G, T, B, hidden, tile)
        total, part = fg.dw_stages(T, B), 8 * G * (hidden * 3 * hidden + 3 * hidden) / fg.DW_PARTIAL_BYTES_PER_US

        def cost(spb):
            P = -(-total // spb)
            return -(-(P * tile["tiles"] * G) // sms) * (spb * fg.DW_STAGE_US + fg.DW_BLOCK_US) + P * part

        best = min(cost(spb) for spb in range(1, min(total, fg.DW_MAX_STAGES) + 1))
        assert cost(tile["stages"]) == pytest.approx(best)


# The weight gradient's layouts as csrc/fused_gru.cu lays them out
# (`gru_dw_kernel`). A stage holds 32 rows k in TMA boxes of 32 x 32 floats
# under the 128-byte swizzle (`dw_box_at`: 16-byte chunk c / 4 of row k at
# chunk (c / 4) ^ (k % 8)): 4 boxes of h_prev's 128 units, then 6 of dgh's
# 192 columns. The split pass writes each dgh value's TF32 parts K-major, row
# n of 32 k (128 bytes), chunk k / 4 at (k / 4) ^ (n % 8), the layout the
# wgmma descriptor names; task t of warp w (8 consumer warps) covers column
# 32 (p // 8) + lane, rows 4 (p % 8) .. + 3, p = 6w + t. The A fragments of
# warp wi of warpgroup wg: rows gid + 8 half (a0, a1 at k = tig; a2, a3 at k
# = tig + 4) of unit `_dw_unit`.
def _dw_box_at(k, c):
    return k * 32 + ((((c >> 2) ^ k) & 7) << 2) + (c & 3)


def _dw_split_at(n, k):
    return n * 32 + (((k >> 2) ^ (n & 7)) << 2) + (k & 3)


def _dw_unit(wg, wi, gid, half):
    return 64 * wg + 32 * (wi >> 1) + (gid & 3) + 4 * (2 * half + (wi & 1)) + 16 * (gid >> 2)


def _dw_a_reads(j=0):
    """The A-fragment reads of k8 step j: for each (warpgroup, warp, lane,
    register), (offset in the stage, unit, k)."""
    out = {}
    for wg, wi, lane, i in np.ndindex(2, 4, 32, 4):
        gid, tig = lane >> 2, lane & 3
        u, k = _dw_unit(wg, wi, gid, i & 1), 8 * j + tig + 4 * (i >> 1)
        out[wg, wi, lane, i] = ((u // 32) * 1024 + _dw_box_at(k, u % 32), u, k)
    return out


def _dw_split_tasks():
    """(warp, task, lane) -> (column n, first row k) of the split pass."""
    return {(w, t, lane): (32 * ((6 * w + t) >> 3) + lane, 4 * ((6 * w + t) & 7))
            for w, t, lane in np.ndindex(8, 6, 32)}


def test_weight_gradient_layouts_are_in_range_one_to_one_and_conflict_free():
    """The stage's boxes, the A-fragment reads, the split pass's reads and
    its K-major writes: every index in range and one-to-one; each warp-wide
    read on 32 banks; each quarter-warp of a 16-byte split write (8 lanes,
    128 bytes) on 32 banks. The split tasks cover the stage's 192 x 32 dgh
    values once, the A reads its 128 x 32 h values once."""
    box = {_dw_box_at(k, c) for k in range(32) for c in range(32)}
    assert box == set(range(1024))
    split = {_dw_split_at(n, k) for n in range(192) for k in range(32)}
    assert split == set(range(192 * 32))
    # the wgmma descriptor's rows: 128 bytes each, 8-row groups 1024 bytes apart
    assert all(_dw_split_at(n, k) // 32 == n for n in range(192) for k in range(32))
    seen = {}
    for j in range(4):
        reads = _dw_a_reads(j)
        for (wg, wi, lane, i), (off, u, k) in reads.items():
            assert 0 <= off < 4 * 1024 and seen.setdefault((u, k), off) == off
        for wg, wi, i in np.ndindex(2, 4, 4):
            assert len({reads[wg, wi, lane, i][0] % 32 for lane in range(32)}) == 32
    assert len(seen) == 128 * 32 and len(set(seen.values())) == 128 * 32
    assert {(u, k) for u, k in seen} == {(u, k) for u in range(128) for k in range(32)}
    tasks = _dw_split_tasks()
    covered = {(n, k + e) for n, k in tasks.values() for e in range(4)}
    assert covered == {(n, k) for n in range(192) for k in range(32)} and len(tasks) * 4 == len(covered)
    for w, t in np.ndindex(8, 6):
        cols = [tasks[w, t, lane] for lane in range(32)]
        for e in range(4):  # the reads: row k + e of one box, 32 columns
            offs = [(n // 32) * 1024 + _dw_box_at(k + e, n % 32) for n, k in cols]
            assert len({o % 32 for o in offs}) == 32
        for q in range(4):  # the float4 writes, a quarter-warp at a time
            offs = [_dw_split_at(n, k) for n, k in cols[8 * q : 8 * q + 8]]
            assert all(o % 4 == 0 for o in offs)
            assert sorted(b for o in offs for b in range(o % 32, o % 32 + 4)) == list(range(32))


def _tf32_np(x):
    return ((x.view(np.int32) + 0x1000) & -0x2000).view(np.float32)


def _emulate_gru_dw(h0, y, dgi, dgh_n, tile):
    """gru_dw_kernel in numpy, block by block: the stage schedule, the TMA
    boxes (zeros past each tensor map's edge), the split pass, the A reads,
    the three products per k8 step in the kernel's order (small * big, big *
    small, big * big, each product of TF32 values exact in f64 and summed in
    f32) and the epilogue. Returns the partials (G, P, H*3H + 3H)."""
    G, T, B, H = y.shape
    H3, K = 3 * H, T * B
    s_h0 = -(-B // 32)
    n_stages = fg.dw_stages(T, B)
    h0_seg, y_seg = h0, y.reshape(G, K, H)[:, : (T - 1) * B]
    dgh = np.concatenate([dgi[..., : 2 * H], dgh_n], -1).reshape(G, K, H3)
    P, spb, tiles_n = tile["P"], tile["stages"], H3 // 192
    out = np.zeros((G, P, H * H3 + H3), np.float32)
    reads = [_dw_a_reads(j) for j in range(4)]
    tasks = _dw_split_tasks()

    def box(src, row, col):  # a 32 x 32 TMA box, zero past the map's edge, in swizzled order
        b = np.zeros((32, 32), np.float32)
        part = src[row : row + 32, col : col + 32]
        b[: part.shape[0], : part.shape[1]] = part
        flat = np.empty(1024, np.float32)
        for k in range(32):
            for c in range(32):
                flat[_dw_box_at(k, c)] = b[k, c]
        return flat

    for g, ty, p in np.ndindex(G, H // 128 * tiles_n, P):
        m0, n0 = (ty // tiles_n) * 128, (ty % tiles_n) * 192
        acc = np.zeros((2, 64, 192), np.float32)  # (warpgroup, fragment row, column)
        db = {}
        for gs in range(p * spb, min(n_stages, (p + 1) * spb)):
            in_h0 = gs < s_h0
            row = gs * 32 if in_h0 else (gs - s_h0) * 32
            valid = min(32, B - row) if in_h0 else min(32, (T - 1) * B - row)
            hsrc, drow = (h0_seg[g], row) if in_h0 else (y_seg[g], B + row)
            stage = np.concatenate([box(hsrc, row, m0 + 32 * j) for j in range(4)]
                                   + [box(dgh[g], drow, n0 + 32 * j) for j in range(6)])
            big, small = np.zeros(192 * 32, np.float32), np.zeros(192 * 32, np.float32)
            for (w, t, lane), (n, k) in tasks.items():
                for e in range(4):
                    v = stage[4096 + (n // 32) * 1024 + _dw_box_at(k + e, lane)]
                    db[w, t, lane] = db.get((w, t, lane), np.float32(0)) + (v if k + e < valid else np.float32(0))
                    b = _tf32_np(np.array([v], np.float32))[0]
                    at = n * 32 + (((k >> 2) ^ (n & 7)) << 2) + e
                    big[at], small[at] = b, np.float32(v - b)
            bb = np.array([[big[_dw_split_at(n, k)] for n in range(192)] for k in range(32)])
            bs = _tf32_truncated(torch.tensor(np.array([[small[_dw_split_at(n, k)] for n in range(192)]
                                                         for k in range(32)]))).numpy()
            for j in range(4):
                a = np.zeros((2, 64, 8), np.float32)
                for (wg, wi, lane, i), (off, u, k) in reads[j].items():
                    a[wg, 16 * wi + (lane >> 2) + 8 * (i & 1), (lane & 3) + 4 * (i >> 1)] = stage[off]
                ab = _tf32_np(a)
                as_ = _tf32_truncated(torch.tensor(a - ab)).numpy()
                kb = slice(8 * j, 8 * j + 8)
                for x, z in ((as_, bb[kb]), (ab, bs[kb]), (ab, bb[kb])):
                    acc = (acc.astype(np.float64) + x.astype(np.float64) @ z.astype(np.float64)).astype(np.float32)
        dw = out[g, p, : H * H3].reshape(H, H3)
        for wg, wi, gid, half in np.ndindex(2, 4, 8, 2):
            dw[m0 + _dw_unit(wg, wi, gid, half), n0 : n0 + 192] = acc[wg, 16 * wi + gid + 8 * half]
        if m0 == 0 and db:
            sums = np.zeros((48, 32), np.float32)
            for (w, t, lane), v in db.items():
                sums[6 * w + t, lane] = v
            for n in range(192):
                out[g, p, H * H3 + n0 + n] = np.float32(sum(sums[(n >> 5) * 8 + kq, n & 31] for kq in range(8)))
    return out


@pytest.mark.parametrize("G,T,B,hidden", [(2, 3, 20, 256), (1, 2, 45, 128)])
def test_weight_gradient_emulation_matches_the_plain_version(G, T, B, hidden):
    """The kernel's index arithmetic and its three-product order, emulated
    in numpy on the tiling `dw_tiling` gives this shape on 132 SMs (and on
    a split into blocks of one stage), against `gru_dw_plain`: dW_hh and
    db_hh within 1e-5 of their largest entry (the product is 3xTF32, the sums
    in f32 in another order). The batches leave a ragged stage in both
    segments (h0's rows and y's)."""
    rng = np.random.default_rng(13)
    h0 = rng.standard_normal((G, B, hidden)).astype(np.float32)
    y = rng.standard_normal((G, T, B, hidden)).astype(np.float32)
    dgi = rng.standard_normal((G, T, B, 3 * hidden)).astype(np.float32)
    dgh_n = rng.standard_normal((G, T, B, hidden)).astype(np.float32)
    dw_ref, db_ref = (r.numpy() for r in fg.gru_dw_plain(*(torch.tensor(a) for a in (h0, y, dgi, dgh_n))))
    stages = fg.dw_stages(T, B)
    for tile in (fg.dw_tiling(G, T, B, hidden, 132), dict(P=stages, stages=1)):
        sums = _emulate_gru_dw(h0, y, dgi, dgh_n, tile).sum(1)
        dw, db = sums[:, : hidden * 3 * hidden].reshape(dw_ref.shape), sums[:, hidden * 3 * hidden :]
        np.testing.assert_allclose(dw, dw_ref, rtol=0, atol=1e-5 * np.abs(dw_ref).max())
        np.testing.assert_allclose(db, db_ref, rtol=0, atol=1e-5 * np.abs(db_ref).max())
