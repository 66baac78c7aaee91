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
    monkeypatch.setattr(fg, "build_library", boom)
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
    monkeypatch.setattr(fg, "_sms", lambda: 132)
    assert fg.forward_blocks_per_group(2, 65536, 16) == 66
    assert fg.forward_blocks_per_group(2, 1024, 16) == 64
    assert fg.forward_blocks_per_group(3, 1000, 16) == 44
    assert fg.forward_blocks_per_group(1, 5, 16) == 1
    assert fg.forward_blocks_per_group(5, 65536, 16) == 26
    assert fg.forward_blocks_per_group(200, 64, 16) == 1


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

    def gru_dw_chunk(self):
        return 64

    def gru_dw_tiles(self, hidden):
        return (hidden // 64) * (3 * hidden // 192)

    def gru_bwd(self, *args):
        self.calls["bwd"] = args[-2]
        return 0

    def gru_dw(self, *args):
        self.calls["dw"] = args[-3:-1]
        return 0


@pytest.mark.parametrize("G,T,B", [(2, 26, 1024), (2, 1, 65536), (3, 7, 1000), (1, 3, 5), (200, 2, 64)])
def test_backward_grids_fill_the_card(monkeypatch, G, T, B):
    """The recurrence runs on the forward's persistent grid (one block per SM
    holds W_hh: 64 blocks of one 16-row tile per group at the update shape);
    the weight gradient splits K = T*B into P blocks of `rows` rows (a
    multiple of the 64-row chunk) per tile of dW_hh, about one block per SM
    over groups and tiles, with no block left empty."""
    lib = _FakeLibrary()
    monkeypatch.setattr(fg, "_sms", lambda: 132)
    monkeypatch.setattr(fg, "_library", lambda: lib)
    monkeypatch.setattr(fg, "_check", lambda shapes, device: None)
    monkeypatch.setattr(fg, "_stream", lambda device: None)
    monkeypatch.setattr(fg, "_ptr", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    gi = torch.empty((G, T, B, 3 * H), device="meta")
    y, h0 = torch.empty((G, T, B, H), device="meta"), torch.empty((G, B, H), device="meta")
    w, b = torch.empty((G, H, 3 * H), device="meta"), torch.empty((G, 3 * H), device="meta")
    fg.gru_bwd_cuda(gi, w, b, h0, y, y, h0)
    partials = fg.gru_dw_cuda(h0, y, gi, y)
    assert lib.calls["bwd"] == fg.forward_blocks_per_group(G, B, 16)
    P, rows = lib.calls["dw"]
    assert partials.shape == (G, P, H * 3 * H + 3 * H)
    assert rows % 64 == 0 and (P - 1) * rows < T * B <= P * rows
    assert P * G * 4 <= max(132, G * 4)
    if (G, T, B) == (2, 26, 1024):
        assert (lib.calls["bwd"], P, rows) == (64, 16, 1664)


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


@pytest.mark.parametrize("G,T,B,H_,P", [(10, 121, 256, 512, 1), (3, 7, 1000, 256, 2), (1, 3, 5, 384, 1),
                                        (2, 26, 1024, 128, 16)])
def test_weight_gradient_split_at_every_hidden_size(monkeypatch, G, T, B, H_, P):
    """`gru_dw` takes H at run time: (H / 64) * (3H / 192) tiles of dW_hh.
    Once the tiles alone fill the card (640 at H=512 G=10, the MMM2 QMIX
    update) every tile sums all T*B rows in one block (P=1), so the sum
    has one fixed order: deterministic with no reduction across blocks."""
    lib = _FakeLibrary()
    monkeypatch.setattr(fg, "_sms", lambda: 132)
    monkeypatch.setattr(fg, "_library", lambda: lib)
    monkeypatch.setattr(fg, "_check", lambda shapes, device: None)
    monkeypatch.setattr(fg, "_stream", lambda device: None)
    monkeypatch.setattr(fg, "_ptr", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    gi = torch.empty((G, T, B, 3 * H_), device="meta")
    y, h0 = torch.empty((G, T, B, H_), device="meta"), torch.empty((G, B, H_), device="meta")
    partials = fg.gru_dw_cuda(h0, y, gi, y)
    got_P, rows = lib.calls["dw"]
    assert got_P == P and partials.shape == (G, P, H_ * 3 * H_ + 3 * H_)
    assert rows % 64 == 0 and (P - 1) * rows < T * B <= P * rows
