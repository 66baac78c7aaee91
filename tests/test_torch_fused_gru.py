"""The port's GRU recurrence (plain version, CPU) against the JAX package's
Pallas kernel run in interpret mode, as `tests/test_fused_gru.py` runs it.

Inputs come from a numpy seed and are handed to both sides; GRU layer
weights come from the JAX `gru_layer_init` and cross with `params_from_numpy`.
Tolerances are the JAX tests' own: 1e-5 for values, 2e-4 for gradients.
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


def test_reduce_partials_plain_is_the_sum_over_blocks():
    p = torch.tensor(np.random.default_rng(5).standard_normal((2, 5, 7)).astype(np.float32))
    np.testing.assert_allclose(fg.reduce_partials_plain(p).numpy(), p.numpy().sum(1), rtol=1e-6)
