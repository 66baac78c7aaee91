"""The profiling CLI's arithmetic (on synthetic trace events) and a tiny CPU
run of it."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from codebase_tpu_torch import profile
from codebase_tpu_torch.config import load_config

torch.set_num_threads(2)


class _Span:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


def _ev(name, device_type, start, end, annotation=False):
    return SimpleNamespace(name=name, device_type=device_type, time_range=_Span(start, end),
                           is_user_annotation=annotation)


def test_device_breakdown_counts_each_kernel_once_and_by_range():
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _ev("dqn/rollout", cpu, 0, 500, True),
        _ev("dqn/rollout", gpu, 100, 400, True),
        _ev("dqn/reward_stream", cpu, 480, 495, True),
        _ev("dqn/reward_stream", gpu, 400, 404, True),
        _ev("dqn/updates", cpu, 500, 900, True),
        _ev("dqn/updates", gpu, 400, 1000, True),
        _ev("aten::bmm", cpu, 10, 20),  # an op event: its kernel's time is not its own
        _ev("gemm", gpu, 100, 160),
        _ev("elementwise", gpu, 401, 403),
        _ev("void (anonymous namespace)::gru_fwd_kernel<8>(float const*)", gpu, 200, 300),
        _ev("void (anonymous namespace)::gru_bwd_kernel<16>(float const*)", gpu, 500, 800),
        _ev("gemm", gpu, 800, 820),
        _ev("Memcpy DtoD (Device -> Device)", gpu, 1100, 1110),  # outside every range
    ]
    out = profile.device_breakdown(events, iters=2, top=2, ranges=profile.RANGES["dqn"])
    assert out["kernel_ms_per_iter"] == pytest.approx((60 + 2 + 100 + 300 + 20 + 10) / 1e3 / 2)
    r = out["ranges"]
    assert r["dqn/rollout"]["kernel_ms_per_iter"] == pytest.approx(160 / 2e3)
    assert r["dqn/updates"]["kernel_ms_per_iter"] == pytest.approx(320 / 2e3)
    assert r["dqn/replay_add"]["kernel_ms_per_iter"] == 0
    assert r["dqn/reward_stream"]["kernel_ms_per_iter"] == pytest.approx(2 / 2e3)
    assert r["dqn/reward_stream"]["host_ms_per_iter_traced"] == pytest.approx(15 / 2e3)
    assert r["dqn/rollout"]["host_ms_per_iter_traced"] == pytest.approx(500 / 2e3)
    assert r["dqn/updates"]["device_span_ms_per_iter"] == pytest.approx(600 / 2e3)
    assert out["gru_kernel_ms_per_iter"]["gru_bwd_kernel"] == pytest.approx(300 / 2e3)
    assert [k["name"] for k in out["top_kernels"]] == [
        "void (anonymous namespace)::gru_bwd_kernel<16>(float const*)",
        "void (anonymous namespace)::gru_fwd_kernel<8>(float const*)",
    ]
    assert out["top_kernels"][0]["calls_per_iter"] == 0.5


def test_device_breakdown_attributes_the_env_step_sub_range_inside_the_rollout():
    """`env/step` lies inside `ac/rollout`: a kernel in both counts once in
    the total and in each of the two; a rollout kernel outside the env step
    (the policy's) counts in the rollout only."""
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _ev("ac/rollout", gpu, 0, 1000, True),
        _ev("env/step", gpu, 100, 300, True),
        _ev("env/step", gpu, 600, 700, True),
        _ev("env/step", cpu, 50, 80, True),
        _ev("compare", gpu, 110, 150),
        _ev("where", gpu, 610, 620),
        _ev("gemm", gpu, 400, 500),
    ]
    out = profile.device_breakdown(events, iters=1, top=3, ranges=profile.RANGES["ac"])
    assert out["kernel_ms_per_iter"] == pytest.approx(150 / 1e3)
    assert out["ranges"]["ac/rollout"]["kernel_ms_per_iter"] == pytest.approx(150 / 1e3)
    step = out["sub_ranges"]["env/step"]
    assert step["kernel_ms_per_iter"] == pytest.approx(50 / 1e3)
    assert step["device_span_ms_per_iter"] == pytest.approx(300 / 1e3)
    assert step["host_ms_per_iter_traced"] == pytest.approx(30 / 1e3)


def test_profile_cli_on_cpu_reports_host_ranges_and_no_device_numbers(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    report = profile.main([
        "+algorithm=idqn", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5",
        "env.parallel_envs=4", "algorithm.model.use_rnn=true", "algorithm.batch_size=2",
        "algorithm.buffer_size=8", "algorithm.training_start=0", "algorithm.updates_per_collect=2",
        "device=cpu", "profile.iters=1", "seed=0",
    ])
    assert report["card"]["name"] == "cpu"
    assert report["env_steps_per_s"] > 0
    assert report["device_busy_share"] is None and report["top_kernels"] is None
    ranges = report["ranges"]
    assert set(ranges) == {"dqn/rollout", "dqn/reward_stream", "dqn/replay_add", "dqn/updates"}
    assert ranges.pop("dqn/reward_stream")["host_ms_per_iter_traced"] == 0  # no standardiser in the stack
    assert all(r["host_ms_per_iter_traced"] > 0 for r in ranges.values())
    assert report["gru_launches_per_iter"] == {"fwd": 0, "bwd": 0, "fwd_wide": 0, "bwd_wide": 0, "dw": 0, "reduce": 0}
    assert report["sub_ranges"]["env/step"]["host_ms_per_iter_traced"] > 0
    # the CPU steps eagerly: no graph captured or replayed
    assert report["env_steps_by_path_per_iter"] == {"graph_captures": 0, "graph_replays": 0,
                                                    "eager": report["policy_steps_per_iter"]}


def test_profile_cli_takes_qmix_and_reads_the_reward_stream_range(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    report = profile.main([
        "+algorithm=qmix", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5",
        "env.parallel_envs=4", "env.standardise_rewards=true", "algorithm.model.use_rnn=true",
        "algorithm.batch_size=2", "algorithm.buffer_size=8", "algorithm.training_start=0",
        "algorithm.updates_per_collect=2", "device=cpu", "profile.iters=1", "seed=0",
    ])
    assert report["config"]["algorithm"] == "qmix" and report["config"]["standardise_rewards"]
    assert all(r["host_ms_per_iter_traced"] > 0 for r in report["ranges"].values())
    with pytest.raises(ValueError, match="unknown algorithm 'nosuch'"):
        profile.main(["+algorithm=idqn", "algorithm.name=nosuch", "env.name=lbforaging:Foraging-5x5-2p-1f-v3",
                      "env.time_limit=5", "device=cpu"])


@pytest.mark.parametrize("standardise_rewards", [False, True])
def test_profile_cli_takes_mappo_and_reads_the_ac_ranges(tmp_path, monkeypatch, standardise_rewards):
    """An actor-critic run reports its own ranges only (`ac/rollout`,
    `ac/reward_stream`, `ac/update`), each with host time when its work ran."""
    monkeypatch.chdir(tmp_path)
    report = profile.main([
        "+algorithm=mappo", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5",
        "env.parallel_envs=4", f"env.standardise_rewards={str(standardise_rewards).lower()}",
        "algorithm.model.actor.use_rnn=true", "algorithm.model.critic.use_rnn=true",
        "device=cpu", "profile.iters=1", "seed=0",
    ])
    config = report["config"]
    assert config["algorithm"] == "mappo" and config["critic"]["centralised"] and config["num_epochs"] == 4
    ranges = report["ranges"]
    assert set(ranges) == {"ac/rollout", "ac/reward_stream", "ac/update"}
    stream = ranges.pop("ac/reward_stream")["host_ms_per_iter_traced"]
    assert (stream > 0) == standardise_rewards
    assert all(r["host_ms_per_iter_traced"] > 0 for r in ranges.values())
    assert report["env_steps_per_s"] > 0 and report["device_busy_share"] is None
    assert report["gru_launches_per_iter"] == {"fwd": 0, "bwd": 0, "fwd_wide": 0, "bwd_wide": 0, "dw": 0, "reduce": 0}  # the CPU path


TINY_IDQN = ["+algorithm=idqn", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5",
             "env.parallel_envs=4", "algorithm.batch_size=2", "algorithm.buffer_size=8",
             "algorithm.training_start=0", "algorithm.updates_per_collect=2", "device=cpu", "seed=0"]


def test_profile_cli_takes_the_jax_packages_chunk_keys(tmp_path, monkeypatch):
    """`profile.chunks` x `profile.chunk_iters` iterations timed as one span
    after a warmup of one chunk, one chunk traced; the report carries the
    JAX report's `algorithm`, `env` and `updates_per_s`."""
    monkeypatch.chdir(tmp_path)
    report = profile.main(TINY_IDQN + ["profile.chunks=2", "profile.chunk_iters=2"])
    assert report["iters"] == 4 and report["traced_iters"] == 2
    assert report["algorithm"] == "idqn" and report["env"] == "lbforaging:Foraging-5x5-2p-1f-v3"
    assert report["updates_per_s"] > 0 and report["env_steps_per_s"] > 0
    assert report["steps"] <= 4 * 4 * 5  # at most E*T steps an iteration
    assert profile.schedule(None) == (1, 3, 3)
    assert profile.schedule(load_config(["profile.chunks=3"]).profile) == (8, 24, 8)


@pytest.mark.parametrize("keys, match", [
    (["profile.bogus=1"], r"unknown profile keys \['profile.bogus'\]"),
    (["profile.iters=2", "profile.chunks=2"], "profile.iters and profile.chunks do not mix"),
])
def test_profile_cli_refuses_unknown_and_mixed_keys(tmp_path, monkeypatch, keys, match):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match=match):
        profile.main(TINY_IDQN + keys)
