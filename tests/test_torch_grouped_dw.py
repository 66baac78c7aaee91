"""The weight gradient of the f32 grouped product (`ops/grouped_dw.py`):
its route, its plain split and sum, the wrappers' refusals and its counters
on the CPU; on the card, the kernels against an f64 `x^T dy` and a
recurrent IDQN update's gradients with the kernels against cuBLAS's. The
card tests skip without a CUDA GPU; this file imports no JAX, so on the
card:

    python -m pytest --noconftest tests/test_torch_grouped_dw.py -q -m cuda
"""

import inspect
import re
import shutil
import statistics
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from codebase_tpu_torch.algos.dqn import DQNModel
from codebase_tpu_torch.config import Config
from codebase_tpu_torch.envs.lbforaging import parse_lbf_name
from codebase_tpu_torch.models import networks
from codebase_tpu_torch.ops import fused_gru as fg
from codebase_tpu_torch.ops import grouped_dw as gd
from codebase_tpu_torch.ops import kernel_lib
from codebase_tpu_torch.ops import matmul
from codebase_tpu_torch.utils import profiling

torch.set_num_threads(2)
# the cells' three products an update: first Linear, GRU input projection,
# final Linear (M, N), at K = (T+1) B rows
PRODUCTS = ((15, 128), (128, 384), (128, 6))
CELL_K = (106_496, 212_992)
# portbench's limit on a leaf's gradient gap (portbench/configs/idqn_rnn_lbf.json)
GRAD_GAP = 1.5e-4
# the QMIX mixer's products an update of the MMM2 cell (M, N), at K = T B =
# 102,400 rows: the four state layers as one (1,660 x their 32 + 32 + 64 +
# 64), hyper_w_1's second layer, hyper_w_final's, the value head's last
MIXER_PRODUCTS = ((1660, 192), (32, 640), (32, 64), (64, 1))
MIXER_K = 102_400


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _inputs(G, K, M, N, seed=0, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((G, K, M), generator=gen, device=device),
            torch.randn((G, K, N), generator=gen, device=device))


def test_route_is_a_function_of_the_shape_alone():
    assert list(inspect.signature(gd.dw_route).parameters) == ["G", "K", "M", "N"]
    for K in CELL_K:
        assert [gd.dw_route(2, K, M, N) for M, N in PRODUCTS] == ["kernel"] * 3
    # below the crossover cuBLAS keeps a product: the wgmma kernel's from
    # 512 rows, the FFMA kernel's from 200
    assert [gd.dw_route(2, 832, M, N) for M, N in PRODUCTS] == ["kernel"] * 3
    assert [gd.dw_route(2, 250, M, N) for M, N in PRODUCTS] == ["kernel", "cublas", "kernel"]
    assert [gd.dw_route(2, 100, M, N) for M, N in PRODUCTS] == ["cublas"] * 3
    assert gd.dw_route(64, 832, 128, 384) == gd.dw_route(2, 832, 128, 384) == "kernel"
    assert [gd.grouped_dw_tiling(2, 212_992, M, N, 132)["variant"] for M, N in PRODUCTS] == ["ffma", "wgmma", "ffma"]
    assert [gd.wgmma_variant(M, N) for M, N in ((64, 64), (64, 128), (128, 128), (130, 128))] == [
        False, True, True, False]


def test_the_lbf_cells_keep_their_launches():
    """The LBF cells' three products keep the route, variant, tile and split
    of K they were measured with (an H100's 132 SMs)."""
    launches = {(K, M, N): (gd.dw_route(2, K, M, N), *(gd.grouped_dw_tiling(2, K, M, N, 132)[k]
                                                       for k in ("variant", "tile", "P")))
                for K in CELL_K for M, N in PRODUCTS}
    assert launches == {
        (106_496, 15, 128): ("kernel", "ffma", (16, 128), 196), (106_496, 128, 384): ("kernel", "wgmma", (128, 192), 33),
        (106_496, 128, 6): ("kernel", "ffma", (128, 8), 196), (212_992, 15, 128): ("kernel", "ffma", (16, 128), 196),
        (212_992, 128, 384): ("kernel", "wgmma", (128, 192), 33), (212_992, 128, 6): ("kernel", "ffma", (128, 8), 196)}


def test_every_weight_gradient_of_the_mmm2_update_takes_the_kernels():
    """QMIX on MMM2 at the cell's batch: the critic's three products (G=10
    unshared agents, K = (T+1) B = 103,424) and the mixer's four (G=1, or a
    sweep's units) are all routed to the kernels, none to cuBLAS."""
    critic = [(10, 101 * 1024, M, N) for M, N in ((166, 128), (128, 384), (128, 18))]
    mixer = [(G, MIXER_K, M, N) for G in (1, 2) for M, N in MIXER_PRODUCTS]
    assert {gd.dw_route(*shape) for shape in critic + mixer} == {"kernel"}
    # the state product's last row tile is partial: 1,660 = 12 x 128 + 124
    assert gd.grouped_dw_tiling(1, MIXER_K, 1660, 192, 132)["tiles"] == 13


@pytest.mark.parametrize("G,K,M,N", [(2, 212_992, 15, 128), (2, 212_992, 128, 384), (2, 106_496, 128, 6),
                                     (1, 1_000_000, 128, 384), (64, 832, 128, 384), (10, 30_000, 512, 1536)])
def test_partials_stay_under_their_bound_and_split_k_whole(G, K, M, N):
    t = gd.grouped_dw_tiling(G, K, M, N, 132)
    rows = t["rows"] // t["stages"]
    assert t["scratch_bytes"] <= gd.MAX_SCRATCH_BYTES
    assert t["P"] * t["stages"] * rows >= K > (t["P"] - 1) * t["stages"] * rows
    assert t["grid"] == (t["tiles"], t["P"], G)


def test_cpu_product_never_touches_the_kernel_library(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the kernel library was touched on a CPU call")

    for mod, name in ((kernel_lib, "library"), (kernel_lib, "build_library"), (gd, "_library"), (gd, "grouped_dw_cuda"),
                      (gd, "weight_gradient"), (matmul._F32Linear, "apply")):
        monkeypatch.setattr(mod, name, boom)
    x, _ = _inputs(2, 9, 15, 1)
    w = torch.randn(2, 15, 128, requires_grad=True)
    b = torch.zeros(2, 128, requires_grad=True)
    networks.linear(x, w, b).square().sum().backward()
    assert w.grad is not None and profiling.counters() == {}


@pytest.mark.parametrize("G,K,M,N", [(2, 1017, 15, 128), (2, 2049, 128, 6), (1, 700, 128, 384), (3, 333, 30, 7),
                                     (2, 5000, 132, 200), (2, 97, 384, 15), (1, 1000, 1660, 192), (2, 999, 32, 640)])
@pytest.mark.parametrize("rows", [None, 32, 96])
def test_plain_split_and_sum_equal_xt_dy(G, K, M, N, rows):
    """K ragged against every split; M and N edges of 15, 6 and 384 against
    the tiles (16 x 128 and 128 x 8 for the FFMA kernel, 128 x 192 for the
    wgmma kernel)."""
    x, dy = _inputs(G, K, M, N)
    t = gd.grouped_dw_tiling(G, K, M, N, 132)
    if rows is not None:
        t = dict(t, rows=rows)
    partials, dw = gd.grouped_dw_plain(x, dy, t)
    assert partials.shape == (G, -(-K // t["rows"]), M, N)
    ref = torch.bmm(x.double().transpose(1, 2), dy.double())
    torch.testing.assert_close(dw.double(), ref, rtol=0, atol=1e-5 * ref.abs().max().item())
    torch.testing.assert_close(gd.reduce_plain(partials), partials.sum(1), rtol=0, atol=1e-5 * ref.abs().max().item())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """No fallback: the wrappers raise before any build or launch."""
    x, dy = _inputs(2, 64, 15, 6)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gd.grouped_dw_cuda(x, dy)
    with pytest.raises(ValueError, match=r"\(G, K, M\) and dy \(G, K, N\)"):
        gd.grouped_dw_cuda(x, dy[:, :63])
    with pytest.raises(ValueError, match=r"\(G, K, M\) and dy \(G, K, N\)"):
        gd.grouped_dw_cuda(x[0], dy[0])
    with pytest.raises(ValueError, match="empty"):
        gd.grouped_dw_cuda(x[:, :0], dy[:, :0])
    with pytest.raises(ValueError, match=r"\(G, P, M, N\)"):
        gd.grouped_dw_reduce_cuda(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        gd.grouped_dw_reduce_cuda(torch.zeros(2, 3, 4, 4))


def test_counters_rise_once_a_call_and_launch_counts_keep_their_keys(monkeypatch):
    """One call counter a weight gradient, by route and shape; the kernels'
    launches are counters of their own, beside the GRU kernels'
    `launch_counts()`, whose keys stay as they were."""
    assert fg.launch_counts() == {"fwd": 0, "bwd": 0, "fwd_wide": 0, "bwd_wide": 0, "dw": 0, "reduce": 0}
    assert gd.launch_counts() == {"dw": 0, "reduce": 0}
    assert not set(gd.LAUNCHES.values()) & set(fg.LAUNCHES.values())
    # the CPU stands in for the card: the kernels' launches by the plain version
    monkeypatch.setattr(gd, "grouped_dw_cuda", lambda x, dy: gd.grouped_dw_plain(
        x, dy, gd.grouped_dw_tiling(*x.shape, dy.shape[-1], 132))[0])
    monkeypatch.setattr(gd, "grouped_dw_reduce_cuda", gd.reduce_plain)
    for K, route in ((4096, "kernel"), (100, "cublas")):
        x, _ = _inputs(2, K, 15, 1)
        w = torch.randn(2, 15, 128, requires_grad=True)
        y = matmul._F32Linear.apply(x, w, None)
        (dw,) = torch.autograd.grad(y.square().sum(), w)
        ref = torch.bmm(x.transpose(1, 2), 2 * y.detach())
        torch.testing.assert_close(dw, ref, rtol=0, atol=1e-5 * ref.abs().max().item())
        assert profiling.counters()[("linear/dw", route, (2, K, 15, 128))] == 1
    profiling.count(gd.LAUNCHES["dw"], 3)
    assert gd.launch_counts() == {"dw": 3, "reduce": 0}
    assert fg.launch_counts() == dict.fromkeys(fg.LAUNCHES, 0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from codebase_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")  # full-f32 matmuls, as the entry points set


def _dw(x, dy):
    partials = gd.grouped_dw_cuda(x, dy)
    return partials[:, 0] if partials.shape[1] == 1 else gd.grouped_dw_reduce_cuda(partials)


@pytest.mark.cuda
@pytest.mark.parametrize("G,K,M,N", [(2, K, M, N) for K in CELL_K for M, N in PRODUCTS] + [
    (2, 832, 15, 128), (2, 832, 128, 384), (2, 250, 128, 6), (2, 100_003, 15, 128), (2, 100_003, 128, 384),
    (2, 100_003, 128, 6), (3, 5001, 30, 7), (3, 20_011, 132, 200)])
def test_kernels_match_f64_and_are_deterministic(cuda_device, G, K, M, N):
    """The cells' three products at both cells' K, gate shapes (K = 26 x 32,
    25 x 10) and ragged K, M and N: within 1e-4 of the largest entry of an
    f64 x^T dy (the gru_dw test's tolerance); two calls bitwise equal; one
    launch of each kernel a call (no reduction where P = 1)."""
    x, dy = _inputs(G, K, M, N, seed=5, device=cuda_device)
    first = _dw(x, dy)
    counts = gd.launch_counts()
    second = _dw(x, dy)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    P = gd.grouped_dw_tiling(G, K, M, N, kernel_lib.sms())["P"]
    assert gd.launch_counts() == {"dw": 2, "reduce": 2 if P > 1 else 0} and counts["dw"] == 1
    ref = torch.bmm(x.double().transpose(1, 2), dy.double())
    torch.testing.assert_close(first.double(), ref, rtol=0, atol=1e-4 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["grouped_dw_kernel", "grouped_dw_ffma_kernel"])
def test_kernels_keep_f32_precision(cuda_device, kernel):
    """The wgmma kernel's products are warpgroup HGMMA in TF32, three a k8
    step (3xTF32: the f64 agreement above, which one TF32 pass misses); the
    FFMA kernel's are FFMA, with no tensor-core product (`HFMA2.MMA`, a
    register move on the FMA pipe, is none)."""
    tool = shutil.which("cuobjdump") or str(Path(kernel_lib._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(kernel_lib.build_library())], capture_output=True, text=True,
                          check=True).stdout
    (function,) = [f for f in sass.split("Function : ")[1:] if kernel in f.splitlines()[0]]
    lines = function.splitlines()
    if kernel == "grouped_dw_kernel":
        assert any("HGMMA" in line and "TF32" in line for line in lines)
    else:
        products = [line for line in lines if re.search(r"\b[HIDQ]G?MMA\b", line)]
        assert any("FFMA" in line for line in lines) and not products, products[:4]


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("M,N", MIXER_PRODUCTS)
def test_mixer_shapes_match_plain_and_f64(cuda_device, G, M, N):
    """The mixer's products at the MMM2 cell's K (G=1, and a sweep's two
    units): routed to the kernels and counted so; the partial last row tile
    of 1,660 and the tiles past 32 rows and 640 columns written only where
    dW is; within 1e-4 of the largest entry of an f64 x^T dy, as above, and
    of the plain split and sum at the same tiling."""
    x, dy = _inputs(G, MIXER_K, M, N, seed=7, device=cuda_device)
    got = gd.weight_gradient(x, dy)
    tiling = gd.grouped_dw_tiling(G, MIXER_K, M, N, kernel_lib.sms())
    _, plain = gd.grouped_dw_plain(x, dy, tiling)
    torch.cuda.synchronize()
    assert profiling.counters()[("linear/dw", "kernel", (G, MIXER_K, M, N))] == 1
    ref = torch.bmm(x.double().transpose(1, 2), dy.double())
    scale = ref.abs().max().item()
    torch.testing.assert_close(got.double(), ref, rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-4 * scale)


def _leaf_gaps(got, ref):
    """Each leaf's |got - ref| over max(|ref|, the median leaf's |ref|)."""
    med = statistics.median(float(r.norm()) for r in ref)
    return [float((g - r).norm()) / max(float(r.norm()), med) for g, r in zip(got, ref)]


@pytest.mark.cuda
def test_update_gradients_with_the_kernels_match_cublas(cuda_device, monkeypatch):
    """One recurrent IDQN update at the replay32 cell's batch (G=2, T+1=26,
    B=8192): its gradients with the weight gradients on the kernels against
    the same with every weight gradient forced to cuBLAS, each leaf within
    portbench's `grad_gap` limit; the kernels take the update's three f32
    weight gradients."""
    env = parse_lbf_name("lbforaging:Foraging-8x8-2p-3f-v3")
    model_cfg = dict(name="qnetwork", layers=[128, 128], parameter_sharing=False, use_orthogonal_init=True,
                     use_rnn=True)
    model = DQNModel.create(env, Config(model_cfg), Config(dict(gamma=0.99, double_q=True)),
                            torch.Generator().manual_seed(0)).to(cuda_device)
    target = DQNModel.create(env, Config(model_cfg), Config(dict(gamma=0.99, double_q=True)),
                             torch.Generator().manual_seed(1)).to(cuda_device)
    N, T, B, D = env.n_agents, 25, 8192, env.obs_dim
    rng = np.random.default_rng(2)
    lengths = rng.integers(1, T + 1, size=B)
    batch = dict(
        obss=rng.integers(-1, 8, size=(N, T + 1, B, D)).astype(np.float32),
        actions=rng.integers(0, 6, size=(N, T, B)),
        rewards=(rng.random((N, T, B)) * (rng.random((N, T, B)) < 0.3)).astype(np.float32),
        dones=np.concatenate([np.zeros((1, B)), np.arange(T)[:, None] == lengths[None] - 1]).astype(np.float32),
        filled=(np.arange(T)[:, None] < lengths[None]).astype(np.float32),
    )
    batch = {k: torch.as_tensor(v, device=cuda_device) for k, v in batch.items()}

    def grads():
        loss, _ = model.loss(target, batch, model.init_rms(cuda_device))
        return torch.autograd.grad(loss, model.param_leaves())

    on = grads()
    calls = {k: n for k, n in profiling.counters().items() if isinstance(k, tuple) and k[0] == "linear/dw"}
    K = (T + 1) * B
    assert calls == {("linear/dw", "kernel", (N, K, M, Nn)): 1 for M, Nn in ((D, 128), (128, 384), (128, 6))}
    monkeypatch.setattr(gd, "dw_route", lambda G, K, M, N: "cublas")
    off = grads()
    torch.cuda.synchronize()
    assert max(_leaf_gaps(on, off)) <= GRAD_GAP
