"""The QMIX mixer on the port's f32 product path against the benchmark's
plain reference (`portbench/reference/qnet.qmix`), on seeded random
weights: Q_tot and the gradient of every leaf and of the agents' values,
for one and two hypernetwork layers and for one unit and a sweep's two.

On the CPU the products are `torch.bmm`; the "split_k" cases put the CPU
in the card's place (the product's backward through `matmul._F32Linear`,
the split-K kernels by their plain version, every shape routed to them), so
the four state layers' one product and the weight gradients' shapes are
checked here too. The last test needs a CUDA GPU and skips without one; it
runs the mixer at the MMM2 cell's widths through the kernels. This file
imports no JAX, so on the card:

    python -m pytest --noconftest tests/test_torch_qmix_mixer.py -q -m cuda
"""

import pytest
import torch

from codebase_tpu_torch.models import networks
from codebase_tpu_torch.models.mixers import QMixer
from codebase_tpu_torch.ops import grouped_dw as gd
from codebase_tpu_torch.ops import grouped_mm as gm
from codebase_tpu_torch.ops import matmul
from codebase_tpu_torch.utils import profiling
from codebase_tpu_torch.utils.params import tree_leaves
from portbench.reference import qnet

torch.set_num_threads(2)
N, S, E, HE, T, B = 3, 24, 8, 4, 5, 7
# f32 against f32 in another order of summation (the four state layers as
# one product, the mixing einsums, the split-K partials): a few ulps of
# sums over at most S or T*B terms, far under 1e-5 of the values
RTOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.fixture
def split_k(monkeypatch):
    """The card's f32 product on the CPU: `_F32Linear` where a weight takes
    a gradient (its forward and dX `torch.bmm`), its dW by the kernels' plain
    split and sum, any K routed to them."""

    def product(x, w, compute_dtype="float32"):
        if w.requires_grad and torch.is_grad_enabled():
            return matmul._F32Linear.apply(x, w, None)
        return torch.bmm(x, w)

    monkeypatch.setattr(matmul, "grouped_matmul", product)
    monkeypatch.setattr(gm, "KERNEL_MIN_ROWS", dict.fromkeys(gm.KERNEL_MIN_ROWS, 2**62))  # forward, dX: bmm
    monkeypatch.setattr(gd, "KERNEL_MIN_K", {"ffma": 1, "wgmma": 1})
    monkeypatch.setattr(gd, "grouped_dw_cuda", lambda x, dy: gd.grouped_dw_plain(
        x, dy, gd.grouped_dw_tiling(*x.shape, dy.shape[-1], 132))[0])
    monkeypatch.setattr(gd, "grouped_dw_reduce_cuda", gd.reduce_plain)


def _unit(tree, u, n_units):
    if isinstance(tree, dict):
        return {k: _unit(v, u, n_units) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unit(v, u, n_units) for v in tree]
    return tree[u] if n_units > 1 else tree


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def _reference(tree, qs, states, n_units, n_agents):
    """Q_tot of each unit by the plain reference, (U, T, B) or (T, B)."""
    if n_units == 1:
        return qnet.qmix(tree, qs, states)
    return torch.stack([qnet.qmix(_unit(tree, u, n_units), qs[u * n_agents:(u + 1) * n_agents], states[u])
                        for u in range(n_units)])


def _mixer(hypernet_layers, n_units, n_agents=N, state_dim=S, embed=E, hyper_embed=HE, device="cpu"):
    gens = [torch.Generator().manual_seed(3 + u) for u in range(n_units)]
    return QMixer(n_agents, state_dim, embed, hypernet_layers, hyper_embed,
                  generator=gens if n_units > 1 else gens[0], device=device)


def _away_from_kinks(mixer):
    """Shift the inputs of every relu and |.| of the mixer to about 1 (each
    such layer's weights scaled by 0.1, its bias raised by 1): no kink then
    lies between two f32 roundings of a pre-activation, so each gradient is
    one smooth function's on both sides. At the cell's widths a |.| input
    within rounding of 0 is otherwise likely among millions, and moves a
    bias gradient by a whole row's share."""
    p = mixer.param_tree()
    with torch.no_grad():
        for layer in (p["hyper_w_1"][0], p["hyper_w_1"][-1], p["hyper_w_final"][0], p["hyper_w_final"][-1], p["v"][0]):
            layer["w"].mul_(0.1)
            layer["b"].add_(1.0)


def _compare(hypernet_layers, n_units, rtol, n_agents=N, state_dim=S, embed=E, hyper_embed=HE, rows=(T, B),
             device="cpu", smooth=False):
    """Q_tot and the gradients of sum(Q_tot * w) with respect to every leaf
    and the agents' values, the port's mixer against the reference on the
    same leaves, each within `rtol` of the largest entry."""
    mixer = _mixer(hypernet_layers, n_units, n_agents, state_dim, embed, hyper_embed, device)
    if smooth:
        _away_from_kinks(mixer)
    gen = torch.Generator().manual_seed(11)
    lead = (n_units,) if n_units > 1 else ()
    qs = torch.randn((n_units * n_agents,) + rows, generator=gen).to(device).requires_grad_()
    states = torch.rand(lead + rows + (state_dim,), generator=gen).to(device)
    weights = torch.randn(lead + rows, generator=gen).to(device)
    leaves = tree_leaves(mixer.param_tree())
    got = mixer(qs, states)
    grads = torch.autograd.grad((got * weights).sum(), leaves + [qs])
    ref_leaves = [x.detach().clone().requires_grad_() for x in leaves]
    ref_qs = qs.detach().clone().requires_grad_()
    want = _reference(_rebuild(mixer.param_tree(), iter(ref_leaves)), ref_qs, states, n_units, n_agents)
    ref_grads = torch.autograd.grad((want * weights).sum(), ref_leaves + [ref_qs])
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * want.abs().max().item())
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=rtol, atol=rtol * r.abs().max().item())


@pytest.mark.parametrize("n_units", [1, 2])
@pytest.mark.parametrize("hypernet_layers", [1, 2])
def test_mixer_matches_the_reference(hypernet_layers, n_units):
    _compare(hypernet_layers, n_units, RTOL)
    assert profiling.counters() == {}  # the CPU's products: no weight gradient kernel


@pytest.mark.parametrize("n_units", [1, 2])
@pytest.mark.parametrize("hypernet_layers", [1, 2])
def test_mixer_on_the_split_k_path_matches_the_reference(split_k, hypernet_layers, n_units):
    """The four state layers as one product (S x their widths side by side),
    each hypernetwork's second layer and the value head's last: one
    kernel-routed weight gradient each, G = U."""
    _compare(hypernet_layers, n_units, RTOL)
    K = T * B
    if hypernet_layers == 2:
        shapes = [(S, HE + HE + E + E), (HE, N * E), (HE, E), (E, 1)]
    else:
        shapes = [(S, N * E + E + E + E), (E, 1)]
    assert {k: n for k, n in profiling.counters().items() if k[0] == "linear/dw"} == {
        ("linear/dw", "kernel", (n_units, K, M, Nn)): 1 for M, Nn in shapes}


def test_mixer_leaves_and_layout_are_unchanged():
    """The side-by-side weight is formed at call time: the tree keeps its
    leaves, names and shapes (no group axis for one unit)."""
    tree = _mixer(2, 1).param_tree()
    assert sorted(tree) == ["hyper_b_1", "hyper_w_1", "hyper_w_final", "v"]
    assert [tuple(x.shape) for x in tree_leaves(tree)] == [
        (E,), (S, E), (HE,), (S, HE), (N * E,), (HE, N * E), (HE,), (S, HE), (E,), (HE, E), (E,), (S, E), (1,), (E, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_units", [1, 2])
def test_mixer_at_the_mmm2_widths_on_the_card(n_units):
    """On the card, at the MMM2 cell's widths (N=10, S=1660, E=64,
    hypernet_embed 32) and 4096 rows, with weights away from the kinks:
    Q_tot and every gradient within the reference's f32 (TF32 off) at 1e-4
    of the largest entry (the 3xTF32 weight gradients sum 4096 rows, about
    2e-5 off an f64 sum at the cell's 102,400; one TF32 pass is about
    1e-3), and every weight gradient kernel-routed at its shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the weight gradient kernels have no CPU mode")
    from codebase_tpu_torch.utils.device import resolve_device

    _compare(2, n_units, 1e-4, n_agents=10, state_dim=1660, embed=64, hyper_embed=32, rows=(64, 64),
             device=resolve_device("cuda"), smooth=True)
    K = 64 * 64
    assert {k: n for k, n in profiling.counters().items() if k[0] == "linear/dw"} == {
        ("linear/dw", "kernel", (n_units, K, M, Nn)): 1 for M, Nn in ((1660, 192), (32, 640), (32, 64), (64, 1))}
