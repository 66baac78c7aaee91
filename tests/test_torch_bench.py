"""The port's bench (`codebase_tpu_torch/bench_suite.py`, `bench.py`) against
the JAX package's: the same lanes and the same analytic FLOPs; tiny lanes
run on the CPU; the CLI's line and exit code; the byte counter."""

import json

import pytest
import torch

from codebase_tpu import bench_suite as jax_bench
from codebase_tpu.config import load_config as jax_load_config
from codebase_tpu.envs.factory import make_env as jax_make_env
from codebase_tpu_torch import bench, bench_suite
from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.ops import fused_gru, kernel_lib
from codebase_tpu_torch.run import build_envs
from codebase_tpu_torch.utils import profiling

torch.set_num_threads(2)

TINY_DQN = dict(
    algo="idqn",
    env="lbforaging:Foraging-5x5-2p-1f-v3",
    time_limit=5,
    overrides=[
        "algorithm.parallel_envs=8",
        "algorithm.batch_size=4",
        "algorithm.updates_per_collect=2",
        "algorithm.buffer_size=32",
        "algorithm.training_start=0",
    ],
)
TINY_AC = dict(algo="ia2c", env="lbforaging:Foraging-5x5-2p-1f-v3", time_limit=5,
               overrides=["algorithm.parallel_envs=8"])


def _argv(spec):
    return [f"+algorithm={spec['algo']}", f"env.name={spec['env']}", f"env.time_limit={spec['time_limit']}",
            *spec["overrides"]]


def test_lanes_are_the_jax_packages():
    assert bench_suite.CONFIGS == jax_bench.CONFIGS
    assert list(bench_suite.CONFIGS) == list(jax_bench.CONFIGS)


@pytest.mark.parametrize("key", list(jax_bench.CONFIGS))
def test_analytic_flops_equal_the_jax_packages(key):
    """Each lane's analytic matmul count, on its own env and config, in
    both packages: the same numbers, exactly."""
    spec = jax_bench.CONFIGS[key]
    T = spec["time_limit"]
    jcfg = jax_load_config(_argv(spec))
    jenv_cfg = jcfg.env.to_dict()
    jenv_cfg.pop("parallel_envs", None)
    jenv = jax_make_env(jenv_cfg.pop("name"), **jenv_cfg)
    cfg = load_config(_argv(spec))
    env, _ = build_envs(cfg)
    assert (env.n_agents, tuple(env.obs_dims), tuple(env.action_dims)) == (
        jenv.n_agents, tuple(jenv.obs_dims), tuple(jenv.action_dims))
    for n_updates in (1, 8):
        got = bench_suite.analytic_flops(env, cfg.algorithm, T, n_updates)
        want = jax_bench.analytic_flops(jenv, jcfg.algorithm, T, n_updates)
        assert got == want and got[0] > 0 and got[1] > 0


@pytest.mark.parametrize("key, tiny", [("idqn_lbf", TINY_DQN), ("ia2c_lbf", TINY_AC)])
def test_run_config_scaled_down_on_the_cpu(monkeypatch, key, tiny):
    monkeypatch.setitem(bench_suite.CONFIGS, key, tiny)
    res = bench_suite.run_config(key, windows=1, window_iters=2, device="cpu")
    assert list(res)[:12] == ["config", "algo", "env", "env_steps_per_s", "flops_per_step",
                              "analytic_flops_per_step", "bytes_per_step", "device_flops_per_s", "mfu",
                              "mfu_source", "mfu_peak", "hbm_bandwidth_util"]
    assert res["algo"] == tiny["algo"] and res["device_kind"] == "cpu"
    assert res["env_steps_per_s"] > 0
    assert res["flops_per_step"] > 0 and res["bytes_per_step"] > 0
    assert res["mfu_source"] == "analytic_matmul" and res["mfu_peak"] == "fp32_flops"
    assert res["mfu"] is None and res["hbm_bandwidth_util"] is None  # no card, no peak
    assert res["gru_launches_per_iter"] == dict.fromkeys(("fwd", "bwd", "fwd_wide", "bwd_wide", "dw", "reduce"), 0)


def test_peaks_follow_the_card_and_the_lanes_arithmetic():
    assert bench_suite.card_peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    assert bench_suite.card_peaks("NVIDIA H100 PCIe")["hbm_bytes_per_s"] == 2.0e12
    assert bench_suite.card_peaks("NVIDIA A100-SXM4-80GB") is None
    peaks = {key: bench_suite.mfu_peak(load_config(_argv(spec)).algorithm) for key, spec in bench_suite.CONFIGS.items()}
    assert {k for k, v in peaks.items() if v == "bf16_flops"} == {"qmix_smaclite_mmm2_big", "mappo_smaclite_mmm2_big"}
    assert set(peaks.values()) == {"bf16_flops", "fp32_flops"}


@pytest.mark.parametrize("failing", [None, "ia2c_lbf"])
def test_bench_cli_prints_one_line_and_exits_1_on_a_failed_lane(monkeypatch, capsys, failing):
    """One JSON line, the bulky suite first and the headline last; a lane
    that raises is recorded as an error, the line is still printed, and the
    exit code is 1."""
    monkeypatch.setattr(bench_suite, "CONFIGS", {"idqn_lbf": TINY_DQN, "ia2c_lbf": TINY_AC})
    run_config = bench_suite.run_config

    def patched(key, **kwargs):  # windows of 2 iterations, not 16: the line is under test
        if key == failing:
            raise RuntimeError("lane broke")
        return run_config(key, window_iters=2, **kwargs)

    monkeypatch.setattr(bench_suite, "run_config", patched)
    rc = bench.main(["--device", "cpu", "--windows", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert list(out) == ["suite", "summary", "metric", "value", "unit", "card"]
    assert out["metric"] == "idqn_train_env_steps_per_s" and out["card"] == "cpu"
    assert out["value"] == out["suite"]["idqn_lbf"]["env_steps_per_s"] > 0
    assert out["summary"]["idqn_lbf"]["mfu"] is None
    if failing:
        assert rc == 1
        assert out["suite"][failing] == {"error": "RuntimeError: lane broke"}
        assert out["summary"][failing] == {"error": True}
    else:
        assert rc == 0 and out["summary"]["ia2c_lbf"]["steps_per_s"] > 0


def test_byte_counter_counts_a_product_exactly_and_a_view_as_nothing():
    m, k, n = 3, 5, 7
    a, b = torch.randn(m, k), torch.randn(k, n)
    with profiling.count_operations() as ops:
        a @ b
    assert ops["bytes"] == 4 * (m * k + k * n + m * n)
    assert ops["flops"] == 2 * m * k * n
    with profiling.count_operations() as ops:
        a.view(k, m)
        a.t()
        torch.empty(100)
    assert ops["bytes"] == 0


def test_count_operations_takes_the_bf16_product_of_the_card():
    """`bmm.dtype` (bf16 inputs, an f32 result: the bf16 lanes' product on
    the card) counts 2*b*m*n*k operations; `FlopCounterMode`'s own formula
    mistakes its `out_dtype` for an output shape. Meta tensors carry the
    overload, which has no CPU kernel."""
    a = torch.empty(2, 3, 4, dtype=torch.bfloat16, device="meta")
    b = torch.empty(2, 4, 5, dtype=torch.bfloat16, device="meta")
    with profiling.count_operations() as ops:
        out = torch.bmm(a, b, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    assert ops["flops"] == 2 * 2 * 3 * 4 * 5
    assert ops["bytes"] == 2 * (2 * 3 * 4 + 2 * 4 * 5) + 4 * 2 * 3 * 5


def test_gru_launches_add_their_bytes_to_the_count():
    """A GRU kernel launch (which no dispatch mode sees) adds
    `kernel_bytes`: each f32 input read once, each output written once."""
    G, T, B, H = 2, 5, 4, 128
    K, H3 = T * B, 3 * H
    weights = H * H3 + H3
    want = {
        "gru_fwd_kernel": K * H3 + weights + B * H + K * H + B * H,
        "gru_bwd_kernel": K * H3 + weights + 2 * B * H + 2 * K * H + K * H3 + B * H + K * H,
        "gru_dw_kernel": K * H + K * H3 + weights,
    }
    for kernel, elements in want.items():
        launch = profiling.cost_analysis(kernel_lib.launched, kernel, {}, G=G, T=T, B=B, H=H)
        assert launch["bytes"] == launch["kernel_bytes"] == 4 * G * elements
    assert fused_gru.kernel_bytes("gru_fwd_wide_kernel", dict(G=G, T=T, B=B, H=H)) == 4 * G * want["gru_fwd_kernel"]
    launch = profiling.cost_analysis(kernel_lib.launched, "gru_reduce_kernel", {}, G=G, P=5, E=7)
    assert launch["bytes"] == 4 * G * 6 * 7
    assert fused_gru.kernel_bytes("gru_backward", dict(G=G, T=T, B=B, H=H)) == 4 * G * (
        K * H3 + weights + 2 * B * H + 2 * K * H + K * H3 + weights + B * H)
