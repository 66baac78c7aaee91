"""The port's tooling on the CPU: `trace_dir` (a parseable Chrome trace with
the iteration's ranges), `utils/profiling.py` (`device_memory_stats`, `cost_analysis` of a Linear and a GRU layer, the GRU
kernels' operation counts), the user-algorithm surface
(`register_algorithm`, `algorithm.entry`, external presets; the port of
`tests/test_extension.py`) and `profile.py` over two gloo ranks."""

import json
import textwrap

import pytest
import torch

from codebase_tpu_torch import profile, run
from codebase_tpu_torch.algos.registry import ALGORITHMS, get_algorithm, register_algorithm
from codebase_tpu_torch.config import load_algorithm_preset
from codebase_tpu_torch.models.networks import gru_layer_init
from codebase_tpu_torch.ops import fused_gru, kernel_lib
from codebase_tpu_torch.utils import profiling

torch.set_num_threads(2)
TINY = ["+algorithm=idqn", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5", "env.parallel_envs=4",
        "algorithm.model.use_rnn=true", "algorithm.batch_size=2", "algorithm.buffer_size=8",
        "algorithm.training_start=0", "algorithm.updates_per_collect=2", "device=cpu", "seed=0"]


def dummy_entry(env, eval_env, logger, time_limit, cfg, device, shard=None):
    # evidence in the run dir: the dispatching import may hold a second
    # instance of this module
    from pathlib import Path

    run_dir = cfg.get("run_dir")
    if run_dir:
        (Path(run_dir) / "dummy_called.txt").write_text(f"{env.n_agents},{time_limit},{cfg.algorithm.name},{device}")
    return {"ok": True}


def test_trace_dir_writes_a_parseable_trace_with_the_ranges(tmp_path):
    run.main(TINY + ["algorithm.total_steps=40", "algorithm.eval_interval=20", "algorithm.log_interval=20",
                     f"trace_dir={tmp_path / 'trace'}", f"run_dir={tmp_path / 'run'}"])
    (path,) = (tmp_path / "trace").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"dqn/rollout", "dqn/replay_add", "dqn/updates", "env/step"} <= names
    assert any(n and n.startswith("aten::") for n in names)


def test_step_timer_and_device_memory_stats():
    # `StepTimer` went with its last reader; the memory statistics stay
    stats = profiling.device_memory_stats()
    assert stats == {} if not torch.cuda.is_available() else all("peak_bytes_in_use" in s for s in stats.values())


def test_cost_analysis_counts_a_linear_and_a_gru_layer():
    lin = torch.nn.Linear(16, 8)
    x = torch.randn(32, 16)
    assert profiling.cost_analysis(lin, x)["flops"] == 2 * 32 * 16 * 8
    G, T, B, H = 2, 5, 4, 16
    params = {k: torch.stack([v, v]) for k, v in gru_layer_init(H, H, torch.Generator().manual_seed(0)).items()}
    x, h0 = torch.randn(G, T, B, H), torch.zeros(G, B, H)
    costs = profiling.cost_analysis(fused_gru.gru_layer_sequence, params, x, h0)
    recurrence = fused_gru.kernel_flops("gru_fwd_kernel", dict(G=G, T=T, B=B, H=H))
    # on the CPU the plain recurrence runs: FlopCounterMode counts its
    # per-step products, which are the forward kernel's operations
    assert costs["flops"] == 2 * G * T * B * H * 3 * H + recurrence and costs["kernel_flops"] == 0
    # a kernel launch (which FlopCounterMode cannot see) adds its own count
    launch = profiling.cost_analysis(kernel_lib.launched, "gru_bwd_kernel", {}, G=G, T=T, B=B, H=H)
    assert launch["flops"] == launch["kernel_flops"] == 2 * recurrence
    assert fused_gru.kernel_flops("gru_reduce_kernel", dict(G=2, P=5, E=7)) == 2 * 4 * 7
    assert kernel_lib.LAUNCH_OBSERVERS == [kernel_lib.debug.check_kernel]  # the counter is gone again


def test_rnn_kernel_bench_runs_on_the_cpu():
    from codebase_tpu_torch import rnn_kernel_bench

    (line,) = rnn_kernel_bench.main(["--device", "cpu", "--shapes", "3x4", "--hidden", "8"])
    assert (line["T"], line["B"], line["H"], line["fused_ms"]) == (3, 4, 8, None)
    assert line["plain_ms"] > 0 and line["cudnn_ms"] > 0 and line["card"]["name"] == "cpu"


def test_register_and_dispatch_and_the_entry_path():
    register_algorithm("dummy_algo", dummy_entry)
    try:
        assert get_algorithm("dummy_algo") is dummy_entry
    finally:
        ALGORITHMS.pop("dummy_algo")
    for path in ("tests.test_torch_tooling:dummy_entry", "tests.test_torch_tooling.dummy_entry"):
        assert get_algorithm("whatever", entry=path).__qualname__ == dummy_entry.__qualname__
    with pytest.raises(ValueError, match="pkg.module:fn"):
        get_algorithm("x", entry="justamodule")
    with pytest.raises(ValueError, match="idqn"):
        get_algorithm("nosuch")


def test_external_preset_and_the_cli_dispatch(tmp_path):
    preset = tmp_path / "my_algo.yaml"
    preset.write_text(textwrap.dedent("""
        defaults: [ia2c]
        algorithm:
          name: my_algo
          entry: tests.test_torch_tooling:dummy_entry
          lr: 0.001
    """))
    data = load_algorithm_preset(str(preset))
    assert data["algorithm"]["name"] == "my_algo" and data["algorithm"]["n_steps"] == 5 and data["algorithm"]["lr"] == 0.001
    with pytest.raises(ValueError, match="not found"):
        load_algorithm_preset("./nope/missing.yaml")
    run.main([f"+algorithm={preset}", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5", "seed=0",
              "device=cpu", f"run_dir={tmp_path / 'run'}"])
    assert (tmp_path / "run" / "dummy_called.txt").read_text() == "2,5,my_algo,cpu"
    # register_algorithm: the name dispatches through run.main too
    register_algorithm("my_registered", dummy_entry)
    try:
        run.main(["+algorithm=idqn", "algorithm.name=my_registered", "env.name=lbforaging:Foraging-5x5-2p-1f-v3",
                  "env.time_limit=5", "device=cpu", f"run_dir={tmp_path / 'reg'}"])
    finally:
        ALGORITHMS.pop("my_registered")
    assert (tmp_path / "reg" / "dummy_called.txt").read_text() == "2,5,my_registered,cpu"


def test_profile_runs_over_two_gloo_ranks(tmp_path, monkeypatch, capsys):
    """`distributed.devices=2 device=cpu`: two spawned ranks each profile
    their shard; rank 0 prints one line with its own report, `world` and
    `ranks` (each with its collectives' ms)."""
    monkeypatch.chdir(tmp_path)
    report = profile.main(TINY + ["profile.iters=1", "distributed.devices=2",
                                  f"profile.trace_dir={tmp_path / 'trace'}"])
    world, ranks = report["world"], report["ranks"]
    assert world["ranks"] == 2 and world["backend"] == "gloo" and world["env_steps_per_s"] > 0
    assert [r["rank"] for r in ranks] == [0, 1] and report["iteration_ms"] == ranks[0]["iteration_ms"]
    assert all(r["collective_ms_per_iter"]["grad"] > 0 and r["collective_ms_per_iter"]["draw"] > 0 for r in ranks)
    assert report["iteration_flops"] > 0 and report["tflops_per_s"] > 0 and world["tflops_per_s"] > 0
    assert sorted(p.name.split(".")[0] for p in (tmp_path / "trace").glob("*.pt.trace.json")) == ["rank0", "rank1"]
    one = profile.main(TINY + ["profile.iters=1"])
    assert "world" not in one and one["collective_ms_per_iter"] is None and one["iteration_flops"] > 0


def test_profile_counts_the_operations_of_the_measured_iterations(tmp_path, monkeypatch):
    """`iteration_flops` is the traced iterations' count: with
    `training_start` = one iteration's steps, the warmup iteration makes no
    update and the measured ones do, and the count equals a run that
    updates from the start; a run that never updates counts fewer."""
    monkeypatch.chdir(tmp_path)
    argv = [a for a in TINY if not a.startswith("algorithm.training_start")] + ["profile.iters=1",
                                                                                "profile.warmup=1"]
    late = profile.main(argv + ["algorithm.training_start=20"])
    early = profile.main(argv + ["algorithm.training_start=0"])
    never = profile.main(argv + ["algorithm.training_start=1000000"])
    assert late["iteration_flops"] == early["iteration_flops"] > never["iteration_flops"] > 0
