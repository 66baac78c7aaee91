"""The port's GRU recurrence (plain version, CPU) against the JAX package's
Pallas kernel run in interpret mode, as `tests/test_fused_gru.py` runs it.

Inputs come from a numpy seed and are handed to both sides; GRU layer
weights come from the JAX `gru_layer_init` and cross with `params_from_numpy`.
Tolerances are the JAX tests' own: 1e-5 for values, 2e-4 for gradients.
The CUDA forward kernel forms `h @ W_hh` in 3xTF32 on tensor cores; its
rounding is emulated here with integer bit ops, so the precision scheme is
held to the JAX kernel before any card run.
"""

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


def _inputs(G, T, B, seed=0):
    rng = np.random.default_rng(seed)
    gi = rng.standard_normal((G, T, B, 3 * H)).astype(np.float32)
    w_hh = (rng.standard_normal((G, H, 3 * H)) * 0.1).astype(np.float32)
    b_hh = (rng.standard_normal((G, 3 * H)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((G, B, H)).astype(np.float32)
    kw = rng.standard_normal((G, B, H)).astype(np.float32)
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
    with pytest.raises(ValueError, match="H=128"):
        fg.gru_fwd_cuda(gi[..., :96], w_hh[:, :32, :96], b_hh[:, :96], h0[..., :32])
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
    """`torch.bmm` as the forward kernel forms it: each operand split into
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
