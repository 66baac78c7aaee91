"""The port on the card: the GRU kernels against their plain version, the
IDQN, QMIX and MAPPO losses through the kernels against the plain CPU path,
a tiny IDQN train run, one QMIX and one MAPPO train iteration, the
SMAClite, RWARE and LBF-grid steps on the card against the CPU steps, and
masked rollouts on the card. Every test needs a CUDA GPU and skips without
one.

This file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import copy
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from codebase_tpu_torch import run
from codebase_tpu_torch.algos import ac
from codebase_tpu_torch.algos.dqn import DQNModel, build_train_functions
from codebase_tpu_torch.config import Config, load_config
from codebase_tpu_torch.envs.factory import make_base_env
from codebase_tpu_torch.envs.lbforaging import parse_lbf_name
from codebase_tpu_torch.envs.vector import collect_episodes
from codebase_tpu_torch.ops import fused_gru as fg
from codebase_tpu_torch.ops.running_stats import RunningMeanStd
from codebase_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.cuda
H = 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return resolve_device("cuda")  # full-f32 matmuls, as the entry points set


def _gru_inputs(G, T, B, seed, hidden=H):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((G, T, B, 3 * hidden)).astype(np.float32),
        (rng.standard_normal((G, hidden, 3 * hidden)) * 0.1 * (H / hidden) ** 0.5).astype(np.float32),
        (rng.standard_normal((G, 3 * hidden)) * 0.1).astype(np.float32),
        rng.standard_normal((G, B, hidden)).astype(np.float32),
        rng.standard_normal((G, T, B, hidden)).astype(np.float32),
        rng.standard_normal((G, B, hidden)).astype(np.float32),
    ]


@pytest.mark.parametrize(
    "G,T,B", [(3, 7, 1000), (2, 1, 4100), (1, 26, 5), (2, 1, 65536), (2, 26, 1000), (2, 3, 9),
              (2, 25, 8192), (2, 1, 8192)]
)
def test_kernels_match_plain_version_on_the_card(cuda_device, G, T, B):
    """Kernels 1-4 against the plain version: ragged batch edges, T=1, a
    batch smaller than one tile, more row tiles than the persistent forward
    grid has blocks (2, 1, 65536), a batch that is not a multiple of the
    16-row tiles, and the actor-critic update and rollout shapes (f) and (g),
    whose dW_hh product sums K = 204,800 rows at (f). Forward at 1e-5; gradients at 1e-4 of each one's
    largest entry (dW_hh and db_hh sum T*B terms in another order)."""
    arrays = _gru_inputs(G, T, B, seed=6)
    ky, kh = (torch.tensor(a, device=cuda_device) for a in arrays[4:])
    t = [torch.tensor(a, device=cuda_device, requires_grad=True) for a in arrays[:4]]
    p = [torch.tensor(a, device=cuda_device, requires_grad=True) for a in arrays[:4]]
    counts = fg.launch_counts()
    y, hT = fg.fused_gru_sequence(*t)
    yr, hTr = fg.gru_sequence_plain(*p)
    torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hT, hTr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hT, y[:, -1], rtol=0, atol=0)
    grads = torch.autograd.grad((y * ky).sum() + (hT * kh).sum(), t)
    ref = torch.autograd.grad((yr * ky).sum() + (hTr * kh).sum(), p)
    torch.cuda.synchronize()
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * r.abs().max().item())
    after = fg.launch_counts()
    assert [after[k] - counts[k] for k in ("fwd", "bwd", "dw", "reduce")] == [1, 1, 1, 1]


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    gi, w, b, h0 = (torch.tensor(a, device=cuda_device) for a in _gru_inputs(1, 2, 8, 0)[:4])
    with pytest.raises(ValueError, match="float32"):
        fg.gru_fwd_cuda(gi.double(), w, b, h0)
    with pytest.raises(ValueError, match="contiguous"):
        fg.gru_fwd_cuda(gi, w, b, h0.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="shape"):
        fg.gru_fwd_cuda(gi, w, b, h0[:, :4])
    with pytest.raises(ValueError, match="CUDA tensor"):
        fg.gru_fwd_cuda(gi, w.cpu(), b, h0)
    shifted = torch.empty(h0.numel() + 1, device=cuda_device)[1:].view(h0.shape)
    with pytest.raises(ValueError, match="aligned"):
        fg.gru_fwd_cuda(gi, w, b, shifted)


def test_reduce_is_deterministic_and_matches_the_plain_sum(cuda_device):
    """The reduction adds the partials in a fixed order, with no atomics:
    two calls give bitwise-equal results, within 1e-5 of the largest entry
    of the plain sum (which adds in another order)."""
    rng = np.random.default_rng(3)
    partials = torch.tensor(rng.standard_normal((2, 64, H * 3 * H + 3 * H)).astype(np.float32),
                            device=cuda_device)
    counts = fg.launch_counts()["reduce"]
    first, second = fg.reduce_partials_cuda(partials), fg.reduce_partials_cuda(partials)
    ref = fg.reduce_partials_plain(partials)
    torch.cuda.synchronize()
    assert fg.launch_counts()["reduce"] - counts == 2
    assert torch.equal(first, second)
    torch.testing.assert_close(first, ref, rtol=0, atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("G,T,B", [(2, 26, 1024), (3, 7, 1000), (2, 1, 65536), (2, 25, 8192)])
def test_backward_is_deterministic_and_matches_its_plain_version(cuda_device, G, T, B):
    """The whole backward (recurrence, weight gradient, reduction) has no
    atomics: two calls on the same inputs are bitwise equal. Against
    `gru_backward_plain` on the same inputs: dgi and dh0 at 1e-5, dW_hh and
    db_hh at 1e-4 of the largest entry (sums of T*B terms in another order)."""
    gi, w, b, h0, dy, dhT = (torch.tensor(a, device=cuda_device) for a in _gru_inputs(G, T, B, seed=9))
    y, _ = fg.gru_fwd_cuda(gi, w, b, h0)
    first = fg.gru_backward_cuda(gi, w, b, h0, y, dy, dhT)
    second = fg.gru_backward_cuda(gi, w, b, h0, y, dy, dhT)
    ref = fg.gru_backward_plain(gi, w, b, h0, y, dy, dhT)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, second))
    for got, r, name in zip(first, ref, ("dgi", "dW_hh", "db_hh", "dh0")):
        atol = 1e-5 if name in ("dgi", "dh0") else 1e-4 * r.abs().max().item()
        torch.testing.assert_close(got, r, rtol=1e-5, atol=atol, msg=name)


def _sass_functions(name):
    tool = shutil.which("cuobjdump") or str(Path(fg._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(fg.build_library())], capture_output=True,
                          text=True, check=True).stdout
    return [f for f in sass.split("Function : ")[1:] if name in f.splitlines()[0]]


@pytest.mark.parametrize("G,T,B,hidden", [(3, 7, 1000, 256), (3, 5, 333, 384), (2, 3, 9, 512), (10, 2, 40, 896)])
def test_wide_kernels_match_plain_version_on_the_card(cuda_device, G, T, B, hidden):
    """The wide variants (H >= 256) through the autograd function: forward
    at 1e-5, gradients at 1e-4 of each one's largest entry, the backward
    bitwise equal in two calls; they count as the wide kernels."""
    arrays = _gru_inputs(G, T, B, seed=6, hidden=hidden)
    ky, kh = (torch.tensor(a, device=cuda_device) for a in arrays[4:])
    t = [torch.tensor(a, device=cuda_device, requires_grad=True) for a in arrays[:4]]
    p = [torch.tensor(a, device=cuda_device, requires_grad=True) for a in arrays[:4]]
    counts = fg.launch_counts()
    y, hT = fg.fused_gru_sequence(*t)
    yr, hTr = fg.gru_sequence_plain(*p)
    torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hT, hTr, rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad((y * ky).sum() + (hT * kh).sum(), t)
    ref = torch.autograd.grad((yr * ky).sum() + (hTr * kh).sum(), p)
    again = fg.gru_backward_cuda(*(x.detach() for x in t), y.detach(), ky, kh)
    torch.cuda.synchronize()
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * r.abs().max().item())
    assert all(torch.equal(u, v) for u, v in zip(grads, (again[0], again[1], again[2], again[3])))
    after = fg.launch_counts()
    assert {k: after[k] - counts[k] for k in after} == {"fwd": 0, "bwd": 0, "fwd_wide": 1, "bwd_wide": 2,
                                                         "dw": 2, "reduce": 2}


@pytest.mark.parametrize("kernel", ["gru_bwd_kernel", "gru_dw_kernel", "gru_bwd_wide_kernel"])
def test_backward_kernels_run_on_tensor_cores(cuda_device, kernel):
    """The backward's three products (h_prev @ W_hh and dgh @ W_hh^T in the
    recurrence, h_prev^T dgh in the weight gradient) are tensor-core MMA in
    TF32, in kernels of this library (no cuBLAS)."""
    functions = _sass_functions(kernel)  # gru_dw_kernel has two instances: H=128 and H at run time
    assert len(functions) == (2 if kernel == "gru_dw_kernel" else 1)
    assert all(any("HMMA" in line and "TF32" in line for line in f.splitlines()) for f in functions)


@pytest.mark.parametrize("kernel", ["gru_fwd_kernel", "gru_fwd_wide_kernel"])
def test_forward_kernel_runs_on_tensor_cores(cuda_device, kernel):
    """The forward's product is tensor-core MMA in TF32: gru_fwd_kernel in
    the built library holds HMMA ... TF32 instructions
    (its 3xTF32 compensation shows in the 1e-5 agreement above, which
    single-pass TF32 misses, see tests/test_torch_fused_gru.py)."""
    functions = _sass_functions(kernel)
    assert len(functions) == (2 if kernel == "gru_dw_kernel" else 1)
    assert all(any("HMMA" in line and "TF32" in line for line in f.splitlines()) for f in functions)


def _loss_on_card_and_cpu(cuda_device, env_name, model_cfg, algo_cfg, rms_shape=None):
    """The loss and gradients of one model on the card (kernel path) and on
    the CPU (plain recurrence), same params, batch and return moments.
    Returns the launches it made, both (loss, grads) and both moments."""
    env = parse_lbf_name(env_name)
    cpu = DQNModel.create(env, Config(model_cfg), Config(algo_cfg), torch.Generator().manual_seed(0))
    cpu_target = DQNModel.create(env, Config(model_cfg), Config(algo_cfg), torch.Generator().manual_seed(1))
    gpu, gpu_target = copy.deepcopy(cpu).to(cuda_device), copy.deepcopy(cpu_target).to(cuda_device)

    N, T, B, D = env.n_agents, 25, 64, env.obs_dim
    rng = np.random.default_rng(2)
    lengths = rng.integers(1, T + 1, size=B)
    batch = dict(
        obss=rng.integers(-1, 8, size=(N, T + 1, B, D)).astype(np.float32),
        actions=rng.integers(0, 6, size=(N, T, B)),
        rewards=(rng.random((N, T, B)) * (rng.random((N, T, B)) < 0.3)).astype(np.float32),
        dones=np.concatenate([np.zeros((1, B)), np.arange(T)[:, None] == lengths[None] - 1]).astype(np.float32),
        filled=(np.arange(T)[:, None] < lengths[None]).astype(np.float32),
    )
    counts = fg.launch_counts()
    losses, grads, moments = [], [], []
    for model, target, dev in ((cpu, cpu_target, "cpu"), (gpu, gpu_target, cuda_device)):
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        rms = model.init_rms(dev)
        if rms_shape is not None:  # moments that have seen data
            rms = RunningMeanStd(torch.full(rms_shape, 0.5, device=dev), torch.full(rms_shape, 2.0, device=dev),
                                 torch.tensor(37.0, device=dev))
        loss, new_rms = model.loss(target, tb, rms)
        losses.append(loss)
        grads.append(torch.autograd.grad(loss, model.param_leaves()))
        moments.append(new_rms)
    torch.cuda.synchronize()
    after = fg.launch_counts()
    launches = {k: after[k] - counts[k] for k in counts}
    torch.testing.assert_close(losses[1].cpu(), losses[0], rtol=1e-4, atol=0)
    for g, r in zip(grads[1], grads[0]):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-4, atol=1e-4 * r.abs().max().item())
    return launches, moments


def test_idqn_loss_through_the_kernels_matches_the_plain_cpu_path(cuda_device):
    """The GRU critic's loss and gradients on the card (kernel path) against
    the same model on the CPU (plain recurrence), same params and batch."""
    launches, _ = _loss_on_card_and_cpu(
        cuda_device, "lbforaging:Foraging-8x8-2p-3f-v3",
        dict(name="qnetwork", layers=[128, 128], parameter_sharing=False, use_orthogonal_init=True, use_rnn=True),
        dict(gamma=0.99, double_q=True),
    )
    assert launches["fwd"] == 2
    assert [launches[k] for k in ("bwd", "dw", "reduce")] == [1, 1, 1]


def test_qmix_loss_with_return_standardisation_matches_the_plain_cpu_path(cuda_device):
    """QMIX with the shared GRU critic (the kernels at G=3) and return
    standardisation: loss, gradients (critic and mixer) and the updated
    return moments on the card against the CPU path."""
    launches, (cpu_rms, gpu_rms) = _loss_on_card_and_cpu(
        cuda_device, "lbforaging:Foraging-10x10-3p-3f-v3",
        dict(name="qmix", layers=[128, 128], parameter_sharing=True, use_orthogonal_init=True, use_rnn=True,
             mixing=dict(embed_dim=64, hypernet_layers=2, hypernet_embed=32)),
        dict(gamma=0.99, double_q=True, standardise_returns=True),
        rms_shape=(1,),
    )
    assert launches["fwd"] == 2 and launches["bwd"] == 1
    assert float(gpu_rms.count) == float(cpu_rms.count) == 37.0 + 25 * 64
    for f in ("mean", "var"):
        torch.testing.assert_close(getattr(gpu_rms, f).cpu(), getattr(cpu_rms, f), rtol=1e-4, atol=0)


def test_tiny_train_run_on_the_card_goes_through_the_kernels(cuda_device, tmp_path):
    fg.reset_launch_counts()
    rows, state = run.main([
        "+algorithm=idqn", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5",
        "env.parallel_envs=64", "algorithm.model.use_rnn=true", "algorithm.total_steps=1000",
        "algorithm.training_start=0", "algorithm.batch_size=16", "algorithm.buffer_size=128",
        "algorithm.updates_per_collect=2", "algorithm.eval_interval=500", "algorithm.log_interval=500",
        "algorithm.eval_episodes=8", "seed=0", "device=cuda", f"run_dir={tmp_path}",
    ])
    torch.cuda.synchronize()
    counts = fg.launch_counts()
    iters = len(state.timings)
    assert counts["fwd"] >= 5 * iters
    assert counts["bwd"] == counts["dw"] == counts["reduce"] == 2 * iters
    assert rows and all(np.isfinite(float(r["loss"])) for r in rows)
    assert (tmp_path / "results.csv").exists()


def test_one_qmix_train_iteration_on_the_card_goes_through_the_kernels(cuda_device):
    """One iteration of the QMIX preset (CooperativeReward, reward
    standardisation) with the shared GRU critic: 5 rollout steps and 2
    updates of the online and target nets through the kernels at G=3."""
    cfg = load_config([
        "+algorithm=qmix", "env.name=lbforaging:Foraging-10x10-3p-3f-v3", "env.time_limit=5",
        "env.standardise_rewards=true", "algorithm.model.use_rnn=true", "algorithm.model.parameter_sharing=true",
        "algorithm.parallel_envs=256", "algorithm.batch_size=32", "algorithm.buffer_size=256",
        "algorithm.updates_per_collect=2", "algorithm.training_start=0",
    ])
    env, eval_env = run.build_envs(cfg)
    init_state, train_iteration, _ = build_train_functions(env, eval_env, cfg.algorithm, 5, cuda_device)
    state = init_state(0)
    counts = fg.launch_counts()
    loss = float(train_iteration(state)["loss"])
    torch.cuda.synchronize()
    after = fg.launch_counts()
    assert np.isfinite(loss) and state.updates == 2
    assert after["fwd"] - counts["fwd"] == 5 + 2 * 2
    assert [after[k] - counts[k] for k in ("bwd", "dw", "reduce")] == [2, 2, 2]
    assert float(state.reward_stream.n.min()) > 0 and state.reward_stream.n.device.type == "cuda"


MAPPO_RNN = ["+algorithm=mappo", "env.name=lbforaging:Foraging-8x8-2p-3f-v3",
             "algorithm.model.actor.use_rnn=true", "algorithm.model.critic.use_rnn=true"]


def test_mappo_loss_through_the_kernels_matches_the_plain_cpu_path(cuda_device):
    """MAPPO with the recurrent actor and the recurrent centralised critic:
    the returns from the target critic and one PPO epoch's loss and
    gradients on the card (kernel path) against the same model on the CPU
    (plain recurrence), same params and rollout."""
    cfg = load_config(MAPPO_RNN)
    env = parse_lbf_name("lbforaging:Foraging-8x8-2p-3f-v3")
    cpu = ac.ACModel.create(env, cfg.algorithm.model, cfg.algorithm, torch.Generator().manual_seed(0))
    cpu_target = ac.ACModel.create(env, cfg.algorithm.model, cfg.algorithm, torch.Generator().manual_seed(1)).critic
    gpu, gpu_target = copy.deepcopy(cpu).to(cuda_device), copy.deepcopy(cpu_target).to(cuda_device)

    N, T, B, D = env.n_agents, 25, 64, env.obs_dim
    rng = np.random.default_rng(3)
    lengths = rng.integers(1, T + 1, size=B)
    filled = (np.arange(T)[:, None] < lengths[None]).astype(np.float32)
    data = dict(
        obs=rng.integers(-1, 8, size=(N, T + 1, B, D)).astype(np.float32),
        actions=rng.integers(0, 6, size=(T, B, N)),
        rewards=(rng.random((T, B, N)) * (rng.random((T, B, N)) < 0.3) * filled[..., None]).astype(np.float32),
        dones=np.concatenate([np.zeros((1, B)), np.arange(T)[:, None] == lengths[None] - 1]).astype(np.float32),
        filled=filled,
        noise=rng.normal(0, 0.3, size=(T, B, N)).astype(np.float32),
    )
    counts = fg.launch_counts()
    out = []
    for model, target, dev in ((cpu, cpu_target, "cpu"), (gpu, gpu_target, cuda_device)):
        t = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
        with torch.no_grad():
            returns, _ = model.compute_returns(target, t["obs"], t["rewards"], t["dones"], model.init_rms(dev))
            old_lp, _ = model.log_probs_entropy(t["obs"][:, :-1], t["actions"])
        loss, _ = model.ppo_loss(returns, old_lp + t["noise"], t["obs"][:, :-1], t["actions"], t["filled"])
        out.append((returns, loss, torch.autograd.grad(loss, model.param_leaves())))
    torch.cuda.synchronize()
    after = fg.launch_counts()
    # the target critic, the old log-probs, then the actor and critic of the epoch
    assert [after[k] - counts[k] for k in ("fwd", "bwd", "dw", "reduce")] == [4, 2, 2, 2]
    (r_cpu, l_cpu, g_cpu), (r_gpu, l_gpu, g_gpu) = out
    torch.testing.assert_close(r_gpu.cpu(), r_cpu, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=1e-4, atol=0)
    for g, r in zip(g_gpu, g_cpu):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-4, atol=1e-4 * r.abs().max().item())


def test_one_mappo_train_iteration_on_the_card_goes_through_the_kernels(cuda_device):
    """One MAPPO iteration with the recurrent actor and critic: 5 rollout
    steps of the actor, the target critic, the old log-probs and 4 epochs
    of actor and critic through the kernels; the target critic takes the
    critic at env step 0; env steps advance by t_max x E."""
    cfg = load_config(MAPPO_RNN + ["env.time_limit=5", "algorithm.parallel_envs=256"])
    env, eval_env = run.build_envs(cfg)
    init_state, train_iteration, _, _ = ac.build_train_functions(env, eval_env, cfg.algorithm, 5, cuda_device)
    state = init_state(0)
    counts = fg.launch_counts()
    out = train_iteration(state)
    loss = float(out["loss"])
    torch.cuda.synchronize()
    after = fg.launch_counts()
    assert np.isfinite(loss) and state.updates == 1
    assert [after[k] - counts[k] for k in ("fwd", "bwd", "dw", "reduce")] == [5 + 1 + 1 + 2 * 4, 8, 8, 8]
    assert state.env_steps == int(out["episode_lengths"].max()) * 256
    target, critic = state.target_critic.param_leaves(), state.model.critic.param_leaves()
    assert all(torch.equal(t, c) for t, c in zip(target, critic))
    assert all(torch.isfinite(p).all() for p in state.model.param_leaves())


def _to(state, device):
    return type(state)(**{k: v.to(device) for k, v in vars(state).items()})


@pytest.mark.parametrize("name", ["smaclite:3m-v0", "smaclite:MMM2-v0", "rware-tiny-2ag-v2",
                                  "lbforaging:Foraging-grid-8x8-2p-3f-v3"])
def test_env_steps_on_the_card_equal_the_cpu_steps(cuda_device, name):
    """The same state and actions on the card and on the CPU for 40 steps
    of 512 envs: states, observations, masks, rewards and flags exactly
    equal (SMAClite divides by constants as products with float32
    reciprocals, which round alike on both). RWARE's requests drawn after a
    delivery come from each device's generator: the CPU's are copied to the
    card after each step, and every env that did not deliver must agree."""
    env = make_base_env(name)
    E = 512
    cpu_state, ts = env.reset_batch(torch.Generator().manual_seed(0), E)
    gpu_state = _to(cpu_state, cuda_device)
    mask = ts.action_mask
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    rewarded = 0
    for t in range(40):
        a = (torch.tensor(rng.random(mask.shape)) * mask).argmax(-1)  # valid actions
        cpu_state, ts = env.step_batch(cpu_state, a, torch.Generator().manual_seed(t), mask)
        gpu_state, gts = env.step_batch(gpu_state, a.to(cuda_device), gen, mask.to(cuda_device))
        torch.cuda.synchronize()
        delivered = ts.reward.sum(1) > 0
        for k, v in vars(cpu_state).items():
            got = getattr(gpu_state, k).cpu()
            if k == "requested":
                assert torch.equal(got[:, ~delivered], v[:, ~delivered])
                gpu_state.requested = v.to(cuda_device)
            else:
                assert torch.equal(got, v), f"step {t} {k}"
        for k in ("reward", "terminated", "truncated", "action_mask"):
            assert torch.equal(getattr(gts, k).cpu(), getattr(ts, k)), f"step {t} {k}"
        if "rware" in name:  # the obs of the copied requests
            assert torch.equal(env._make_obs_batch(gpu_state).cpu(), ts.obs), f"step {t} obs"
        else:
            assert torch.equal(gts.obs.cpu(), ts.obs), f"step {t} obs"
        mask = ts.action_mask
        rewarded += int((ts.reward != 0).sum())
    assert rewarded > 0 or "rware" in name


@pytest.mark.parametrize("algo", ["qmix", "mappo"])
def test_masked_rollout_on_the_card_never_takes_an_invalid_action(cuda_device, algo):
    """Rollouts of 4096 SMAClite 3m envs on the card through the recurrent
    QMIX critic (epsilon 1 and 0: uniform over valid actions, then greedy)
    and the recurrent MAPPO actor: every filled step's action is allowed by
    the mask of the observation it was taken from; the GRU kernels ran."""
    argv = [f"+algorithm={algo}", "env.name=smaclite:3m-v0", "env.time_limit=60"]
    argv += (["algorithm.model.use_rnn=true"] if algo == "qmix"
             else ["algorithm.model.actor.use_rnn=true", "algorithm.model.critic.use_rnn=true"])
    cfg = load_config(argv)
    env, _ = run.build_envs(cfg)
    E = 4096
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    if algo == "qmix":
        model = DQNModel.create(env, cfg.algorithm.model, cfg.algorithm, torch.Generator().manual_seed(0), cuda_device)
        policies, net = [model.policy(1.0), model.policy(0.0)], model.critic
    else:
        model = ac.ACModel.create(env, cfg.algorithm.model, cfg.algorithm, torch.Generator().manual_seed(0), cuda_device)
        policies, net = [model.policy()], model.actor
    counts, steps = fg.launch_counts()["fwd"], 0
    for policy in policies:
        rollout, _ = collect_episodes(env, policy, net.init_hiddens(E), gen, E, 60)
        taken = rollout.action_mask[:-1].gather(-1, rollout.actions.unsqueeze(-1)).squeeze(-1)  # (T, E, N)
        filled = rollout.filled > 0
        assert int((taken[filled] == 0).sum()) == 0
        assert float(rollout.filled.sum(0).mean()) < 60  # episodes end early: padded steps were skipped
        steps += int(rollout.filled.sum(0).max())  # 4096 envs: the early exit stops at the longest episode
    torch.cuda.synchronize()
    assert fg.launch_counts()["fwd"] - counts == steps
