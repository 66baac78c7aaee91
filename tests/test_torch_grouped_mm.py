"""The forward and input-gradient products of the f32 Linear
(`ops/grouped_mm.py`): their route, their plain split and sum, the wrappers'
refusals, their counters and the Linear's autograd on the CPU (standing in
for the card where a test says so); on the card, the kernels against an f64
`x @ w + b`, two calls bitwise equal, their precision, and a recurrent IDQN
update's losses and gradients with the kernels against cuBLAS's. The card
tests skip without a CUDA GPU; this file imports no JAX, so on the card:

    python -m pytest --noconftest tests/test_torch_grouped_mm.py -q -m cuda
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
from codebase_tpu_torch.ops import grouped_mm as gm
from codebase_tpu_torch.ops import kernel_lib
from codebase_tpu_torch.ops import matmul
from codebase_tpu_torch.utils import profiling

torch.set_num_threads(2)
# the products of the benchmark cells' Linear layers, (K, N) as the layer
# has them (in, out): the LBF cells' first Linear, GRU input projection and
# final Linear at G=2 over R = 26 B rows (replay32, collect's updates) and
# the collect's 524,288 rollout envs; MMM2's at G=10 over R = 101 x 1024;
# the QMIX mixer's at G=1 over R = 100 x 1024
LBF = ((15, 128), (128, 384), (128, 6))
LBF_R = (212_992, 106_496, 524_288)
MMM2 = ((166, 128), (128, 384), (128, 18))
MMM2_R = 103_424
MIXER = ((1660, 192), (32, 640), (32, 64), (64, 1))
MIXER_R = 102_400
# portbench's limit on a leaf's gradient gap and on the losses'
# (portbench/configs/idqn_rnn_lbf.json)
GRAD_GAP = 1.5e-4
LOSS_GAP = 7e-5


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _inputs(G, R, K, N, trans=False, bias=True, seed=0, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((G, R, K), generator=gen, device=device)
    w = torch.randn((G, N, K) if trans else (G, K, N), generator=gen, device=device) / K ** 0.5
    b = torch.randn((G, N), generator=gen, device=device) if bias else None
    return x, w, b


def _f64(x, w, b, trans):
    ref = torch.bmm(x.double(), (w.transpose(1, 2) if trans else w).double())
    return ref if b is None else ref + b.double()[:, None]


@pytest.fixture
def stand_in(monkeypatch):
    """The CPU in the card's place: every f32 Linear through
    `matmul.f32_linear`, the product kernels by their plain version, the
    weight gradient's by theirs."""
    monkeypatch.setattr(matmul, "takes_f32_linear", lambda x, w: x.dtype == w.dtype == torch.float32)
    monkeypatch.setattr(gm, "grouped_mm_cuda", gm.grouped_mm_plain)
    monkeypatch.setattr(gd, "grouped_dw_cuda", lambda x, dy: gd.grouped_dw_plain(
        x, dy, gd.grouped_dw_tiling(*x.shape, dy.shape[-1], 132))[0])
    monkeypatch.setattr(gd, "grouped_dw_reduce_cuda", gd.reduce_plain)


def test_route_is_a_function_of_the_shape_alone():
    assert list(inspect.signature(gm.mm_route).parameters) == ["G", "R", "K", "N"]
    assert [gm.mm_variant(K, N)[0] for K, N in LBF] == ["wgmma", "wgmma", "ffma"]
    for G, R, K, N in ((2, 212_992, 128, 384), (10, 1024, 166, 128), (1, 102_400, 1660, 192)):
        assert gm.mm_route(G, R, K, N) == gm.mm_route(G, R, K, N)
    # a B that fits no kernel's shared memory stays on cuBLAS
    assert gm.mm_variant(8000, 30) is None and gm.mm_route(2, 10 ** 6, 8000, 30) == "cublas"


def test_every_update_and_rollout_product_of_the_cells_takes_the_kernels():
    """Forward and input gradient of every Linear layer of the LBF and MMM2
    cells' updates (and the LBF collect's rollout): routed to the kernels,
    none to cuBLAS. The input gradients are of every layer whose input
    takes a gradient: not the first Linear's (observations). The QMIX
    mixer's products at its 102,400 rows: the wgmma kernel's on the kernels;
    the FFMA kernel's (N <= 32: the value head, the input gradients into
    the hypernetworks' hidden layers) stay on cuBLAS below 131,072 rows,
    where it was faster on the card, and take the kernels in a sweep of
    two units."""
    fwd = [(2, R, K, N) for R in LBF_R for K, N in LBF] + [(10, MMM2_R, K, N) for K, N in MMM2]
    dx = [(2, R, N, K) for R in LBF_R for K, N in LBF[1:]] + [(10, MMM2_R, N, K) for K, N in MMM2[1:]]
    assert {gm.mm_route(*shape) for shape in fwd + dx} == {"kernel"}
    mixer = [(K, N) for K, N in MIXER] + [(N, K) for K, N in MIXER[1:]]
    for K, N in mixer:
        variant = gm.mm_variant(K, N)[0]
        assert gm.mm_route(1, MIXER_R, K, N) == ("kernel" if variant == "wgmma" else "cublas")
        assert gm.mm_route(2, MIXER_R, K, N) == "kernel"
    assert gm.mm_variant(1660, 192)[1]["kc"] < 1660  # the state's B comes in chunks of K


def test_small_shapes_stay_on_cublas():
    """Below the measured crossover cuBLAS keeps a product: the evals' 100
    envs, the gates' 10 and their 832-row updates, a sweep's rollout of 32
    envs a unit (G=64), the MMM2 rollout's 1,024 envs."""
    for G, R in ((2, 100), (2, 10), (2, 832), (64, 32), (3, 100), (10, 1024)):
        assert {gm.mm_route(G, R, K, N) for K, N in LBF + MMM2} == {"cublas"}
    for v, rows in gm.KERNEL_MIN_ROWS.items():
        K, N = (128, 384) if v == "wgmma" else (128, 6)
        assert gm.mm_route(2, rows // 2 - 1, K, N) == "cublas" and gm.mm_route(2, rows // 2, K, N) == "kernel"


@pytest.mark.parametrize("G,R,K,N", [(2, 212_992, K, N) for K, N in LBF] + [(10, MMM2_R, K, N) for K, N in MMM2]
                         + [(1, MIXER_R, K, N) for K, N in MIXER] + [(2, 212_992, 384, 128), (64, 832, 640, 32),
                                                                      (3, 5000, 7, 200)])
def test_tilings_fit_the_card(G, R, K, N):
    """Every launch fits an H100 block's shared memory, stages B in whole
    k-blocks, and its grid covers the rows and columns."""
    t = gm.mm_tiling(G, R, K, N, 132)
    assert t["smem"] <= gm.SMEM_PER_BLOCK and t["grid"][2] == G
    if t["variant"] == "wgmma":
        assert t["kc"] % gm.MM_KBLOCK == 0 and t["grid"][1] * t["bn"] >= N > (t["grid"][1] - 1) * t["bn"]
        groups = gm.mm_groups(t["chunks"])
        assert 1 <= t["grid"][0] * groups <= max(groups, -(-R // gm.MM_ROWS) + groups - 1)
    else:
        assert t["np"] >= N and t["np"] % 4 == 0 and t["grid"][0] * gm.FFMA_ROWS >= R


@pytest.mark.parametrize("G,R,K,N", [(2, 1017, 15, 128), (2, 2049, 128, 384), (2, 333, 128, 6), (3, 97, 166, 128),
                                     (2, 500, 128, 18), (1, 300, 1660, 192), (2, 64, 32, 640), (1, 129, 64, 1)])
@pytest.mark.parametrize("trans,bias", [(False, True), (False, False), (True, False)])
def test_plain_split_and_sum_equal_bmm_plus_b(G, R, K, N, trans, bias):
    """The plain version of the kernels' 3xTF32 split and sum (`tf32_split`,
    three products summed in f32) within f32 round-off of an f64 x @ B + b,
    as `torch.bmm` and the add are; transposed B (the input gradient, which
    takes no bias) alike, and ragged rows and widths of 15, 166, 6, 18 and 1."""
    x, w, b = _inputs(G, R, K, N, trans, bias)
    ref = _f64(x, w, b, trans)
    scale = ref.abs().max().item()
    plain = gm.grouped_mm_plain(x, w, b, trans)
    f32 = torch.bmm(x, w.transpose(1, 2) if trans else w) + (0 if b is None else b[:, None])
    assert plain.shape == (G, R, N) and plain.dtype == torch.float32
    torch.testing.assert_close(plain.double(), ref, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(f32.double(), ref, rtol=0, atol=1e-5 * scale)


def test_one_tf32_pass_would_not_do():
    """The split is what keeps f32 precision: one product of the TF32 parts
    alone (1xTF32) misses the f64 result by more than the card tests'
    tolerance (1e-4 of the largest entry); the three stay within 1e-5."""
    x, w, b = _inputs(2, 2000, 128, 384, seed=4)
    ref = _f64(x, w, b, False)
    scale = ref.abs().max().item()
    xb, _ = gm.tf32_split(x)
    wb, _ = gm.tf32_split(w)
    one = torch.bmm(xb, wb) + b[:, None]
    three = gm.grouped_mm_plain(x, w, b)
    assert (three.double() - ref).abs().max().item() <= 1e-5 * scale
    assert (one.double() - ref).abs().max().item() > 1e-4 * scale  # fails the card tests' tolerance


def test_cpu_linear_never_touches_the_kernel_library_and_is_unchanged(monkeypatch):
    """On the CPU `networks.linear` and the GRU layer's input projection are
    `torch.bmm` and the add, bit for bit, with their autograd; nothing of
    the kernels' module runs."""
    def boom(*a, **k):
        raise AssertionError("the kernel path was touched on a CPU call")

    for mod, name in ((kernel_lib, "library"), (kernel_lib, "build_library"), (gm, "_library"),
                      (gm, "grouped_mm_cuda"), (gm, "product"), (matmul, "f32_linear"), (matmul._F32Linear, "apply"),
                      (gd, "weight_gradient")):
        monkeypatch.setattr(mod, name, boom)
    x, w, b = _inputs(2, 9, 15, 128)
    w.requires_grad_(True)
    b.requires_grad_(True)
    y = networks.linear(x.view(2, 3, 3, 15), w, b)
    assert torch.equal(y, (torch.bmm(x, w) + b[:, None]).view(2, 3, 3, 128))
    y.square().sum().backward()
    assert w.grad is not None and b.grad is not None
    params = networks.gru_layer_init(15, 128, torch.Generator().manual_seed(0))
    params = {k: v.expand(2, *v.shape).contiguous() for k, v in params.items()}
    ys, _ = fg.gru_layer_sequence(params, x.view(2, 3, 3, 15), torch.zeros(2, 3, 128))
    gi = (torch.bmm(x, params["w_ih"]).view(2, 3, 3, 384) + params["b_ih"][:, None, None, :])
    assert torch.equal(ys, fg.gru_sequence_plain(gi, params["w_hh"], params["b_hh"], torch.zeros(2, 3, 128))[0])
    assert profiling.counters().get(("gru/forward", (2, 3, 3, 128))) == 1
    assert not any(isinstance(k, tuple) and k[0] in gm.COUNTERS for k in profiling.counters())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """No fallback: the wrappers raise before any build or launch."""
    x, w, b = _inputs(2, 64, 15, 128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gm.grouped_mm_cuda(x, w, b)
    with pytest.raises(ValueError, match=r"x must be \(G, R, K\) and w \(G, K, N\)"):
        gm.grouped_mm_cuda(x, w[:, :14], b)
    with pytest.raises(ValueError, match=r"w \(G, N, K\)"):
        gm.grouped_mm_cuda(x, w, None, trans=True)
    with pytest.raises(ValueError, match=r"x must be \(G, R, K\)"):
        gm.grouped_mm_cuda(x[0], w[0], b)
    with pytest.raises(ValueError, match="empty"):
        gm.grouped_mm_cuda(x[:, :0], w, b)
    with pytest.raises(ValueError, match="bias"):
        gm.grouped_mm_cuda(x, w, b[:, :5])
    with pytest.raises(ValueError, match="bias"):
        gm.grouped_mm_cuda(x, w.transpose(1, 2).contiguous(), b, trans=True)
    big_x, big_w, _ = _inputs(1, 8, 8000, 30, bias=False)
    with pytest.raises(ValueError, match="no kernel takes"):
        gm.grouped_mm_cuda(big_x, big_w)


def test_counters_rise_once_a_call_and_launch_counts_keep_their_keys(stand_in):
    """One call counter a product, by direction, route and shape, and the
    weight gradient's beside them; the kernels' launches are a counter of
    their own (`launch_counts()`), apart from the GRU kernels' and the
    weight gradient's, whose keys stay as they were."""
    assert gm.launch_counts() == {"mm": 0}
    assert fg.launch_counts() == {"fwd": 0, "bwd": 0, "fwd_wide": 0, "bwd_wide": 0, "dw": 0, "reduce": 0}
    assert gd.launch_counts() == {"dw": 0, "reduce": 0}
    assert not set(gm.LAUNCHES.values()) & (set(fg.LAUNCHES.values()) | set(gd.LAUNCHES.values()))
    for R, route in ((gm.KERNEL_MIN_ROWS["wgmma"] // 2, "kernel"), (100, "cublas")):
        x, w, b = _inputs(2, R, 128, 384)
        x.requires_grad_(True)
        w.requires_grad_(True)
        b.requires_grad_(True)
        y = matmul.f32_linear(x, w, b)
        y.square().sum().backward()
        counts = profiling.counters()
        assert counts[("linear/fwd", route, (2, R, 128, 384))] == 1
        assert counts[("linear/dx", route, (2, R, 384, 128))] == 1
        assert counts[("linear/dw", gd.dw_route(2, R, 128, 384), (2, R, 128, 384))] == 1
    with torch.no_grad():
        matmul.f32_linear(x, w, b)
    assert profiling.counters()[("linear/fwd", "cublas", (2, 100, 128, 384))] == 2  # no gradient: the forward alone
    profiling.count(gm.LAUNCHES["mm"], 3)
    assert gm.launch_counts() == {"mm": 3}
    assert fg.launch_counts() == dict.fromkeys(fg.LAUNCHES, 0)


@pytest.mark.parametrize("K,N", [(15, 128), (128, 384), (128, 6), (166, 18)])
def test_linear_autograd_matches_bmm_plus_b(stand_in, monkeypatch, K, N):
    """`networks.linear` on the stand-in: one `f32_linear` call forms x @ w
    + b (no separate add), and its gradients (dX by the transposed product,
    dW by the split-K sum, db the column sum) match torch's autograd of
    `torch.bmm` and the add."""
    monkeypatch.setattr(gm, "KERNEL_MIN_ROWS", dict.fromkeys(gm.KERNEL_MIN_ROWS, 1))  # every product on the kernels
    x, w, b = _inputs(2, 4096, K, N, seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y = networks.linear(leaves[0].view(2, 64, 64, K), leaves[1], leaves[2])
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, leaves, dy)
    refs = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y_ref = (torch.bmm(refs[0], refs[1]) + refs[2][:, None]).view(2, 64, 64, N)
    want = torch.autograd.grad(y_ref, refs, dy)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-5 * y_ref.abs().max().item())
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5 * r.abs().max().item())
    counts = profiling.counters()
    assert counts[("linear/fwd", "kernel", (2, 4096, K, N))] == 1 and counts[("linear/dx", "kernel", (2, 4096, N, K))] == 1


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from codebase_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")  # full-f32 matmuls, as the entry points set


CARD_SHAPES = ([(2, R, K, N) for R in LBF_R for K, N in LBF] + [(10, MMM2_R, K, N) for K, N in MMM2]
               + [(1, MIXER_R, 1660, 192)])
RAGGED = [(2, 100_003, 15, 128), (2, 100_003, 128, 384), (2, 100_003, 128, 6), (3, 5001, 166, 18),
          (3, 20_011, 30, 100), (1, 7777, 1660, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("G,R,K,N", CARD_SHAPES + RAGGED)
@pytest.mark.parametrize("direction", ["fwd", "fwd_nobias", "dx"])
def test_kernels_match_f64_and_are_deterministic(cuda_device, G, R, K, N, direction):
    """The cells' products, forward (with and without the bias) and input
    gradient (w read transposed: the layer's out width is the product's K),
    at the cells' rows and ragged ones: within 1e-4 of the largest entry of
    an f64 x @ B + b (the `grouped_dw` tolerance), within 1e-5 of it in fact
    where one TF32 pass would miss it by far more (`test_one_tf32_pass_would_
    not_do`); two calls bitwise equal; one launch a call."""
    trans = direction == "dx"
    if trans:
        K, N = N, K
    x, w, b = _inputs(G, R, K, N, trans, direction == "fwd", seed=5, device=cuda_device)
    first = gm.grouped_mm_cuda(x, w, b, trans)
    second = gm.grouped_mm_cuda(x, w, b, trans)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and gm.launch_counts() == {"mm": 2}
    ref = _f64(x, w, b, trans)
    scale = ref.abs().max().item()
    err = (first.double() - ref).abs().max().item()
    assert err <= 1e-4 * scale
    assert err <= 1e-5 * scale  # 3xTF32: f32 level, not TF32's


@pytest.mark.cuda
@pytest.mark.parametrize("G,R,K,N,trans", [(2, 4096, 128, 384, False), (3, 1000, 166, 18, False),
                                           (2, 777, 6, 128, True), (1, 3000, 1660, 192, False)])
def test_kernels_match_their_plain_version(cuda_device, G, R, K, N, trans):
    x, w, b = _inputs(G, R, K, N, trans, not trans, seed=6, device=cuda_device)
    got = gm.grouped_mm_cuda(x, w, b, trans)
    plain = gm.grouped_mm_plain(x, w, b, trans)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-5 * plain.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["grouped_mm_kernel", "grouped_mm_ffma_kernel"])
def test_kernels_keep_f32_precision(cuda_device, kernel):
    """The wgmma kernel's products are warpgroup HGMMA in TF32, three a k8
    step (3xTF32: the f64 agreement above, which one TF32 pass misses); the
    FFMA kernel's are FFMA, with no tensor-core product."""
    tool = shutil.which("cuobjdump") or str(Path(kernel_lib._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(kernel_lib.build_library())], capture_output=True, text=True,
                          check=True).stdout
    functions = [f for f in sass.split("Function : ")[1:] if kernel in f.splitlines()[0]]
    assert functions
    for function in functions:
        lines = function.splitlines()
        if kernel == "grouped_mm_kernel":
            assert sum("HGMMA" in line and "TF32" in line for line in lines) >= 3
        else:
            products = [line for line in lines if re.search(r"\b[HIDQ]G?MMA\b", line)]
            assert any("FFMA" in line for line in lines) and not products, products[:4]


def _leaf_gaps(got, ref):
    """Each leaf's |got - ref| over max(|ref|, the median leaf's |ref|)."""
    med = statistics.median(float(r.norm()) for r in ref)
    return [float((g - r).norm()) / max(float(r.norm()), med) for g, r in zip(got, ref)]


@pytest.mark.cuda
def test_update_losses_and_gradients_with_the_kernels_match_cublas(cuda_device, monkeypatch):
    """One recurrent IDQN update at the replay32 cell's batch (G=2, T+1=26,
    B=8192): its loss and gradients with the products on the kernels
    against the same with every product forced to cuBLAS, within
    portbench's `loss_gap` and `grad_gap` limits; the kernels take the
    update's forwards (online and target) and input gradients."""
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

    def run():
        loss, _ = model.loss(target, batch, model.init_rms(cuda_device))
        return float(loss), torch.autograd.grad(loss, model.param_leaves())

    loss_on, on = run()
    calls = {k: n for k, n in profiling.counters().items() if isinstance(k, tuple) and k[0] in gm.COUNTERS}
    R = (T + 1) * B
    fwd = {("linear/fwd", "kernel", (N, R, K, Nn)): 2 for K, Nn in ((D, 128), (128, 384), (128, 6))}
    dx = {("linear/dx", "kernel", (N, R, Nn, K)): 1 for K, Nn in ((128, 384), (128, 6))}
    assert calls == {**fwd, **dx}
    monkeypatch.setattr(gm, "mm_route", lambda G, R, K, N: "cublas")
    loss_off, off = run()
    torch.cuda.synchronize()
    assert abs(loss_on - loss_off) <= LOSS_GAP * abs(loss_off)
    assert max(_leaf_gaps(on, off)) <= GRAD_GAP
