"""The port's spans and counters (`utils/profiling.py`): `span` costs a flag
check when nothing listens, is a profiler range under a profiler and host
time under `host_spans()`; the counter registry holds the GRU kernels'
launches, the recurrence's calls by shape, the rollout's policy steps and
the host syncs; every span name is declared in `SPANS`. The last test needs
a CUDA GPU and skips without one; this file imports no JAX, so on the card:

    python -m pytest --noconftest tests/test_torch_spans.py -q -m cuda
"""

import re
import threading
from pathlib import Path

import pytest
import torch

from codebase_tpu_torch import profile
from codebase_tpu_torch.algos import dqn, dqn_train
from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.envs.factory import make_env
from codebase_tpu_torch.envs.vector import collect_episodes
from codebase_tpu_torch.models import distributions as D
from codebase_tpu_torch.models.networks import gru_layer_init
from codebase_tpu_torch.ops import fused_gru
from codebase_tpu_torch.run import build_envs
from codebase_tpu_torch.utils import profiling

torch.set_num_threads(2)
PACKAGE = Path(__file__).resolve().parents[1] / "codebase_tpu_torch"
TINY = ["+algorithm=idqn", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5", "env.parallel_envs=4",
        "algorithm.model.use_rnn=true", "algorithm.batch_size=2", "algorithm.buffer_size=8",
        "algorithm.training_start=0", "algorithm.updates_per_collect=2", "seed=0"]
# the spans inside the iteration's ranges that this file holds to the card
INNER = ("dqn/sample", "dqn/optimizer", "gru/forward", "gru/backward", "linear/dw", "sync/rollout_seed",
         "sync/early_exit", "sync/replay_filled", "sync/loss")


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def tiny_iteration(device="cpu"):
    """A tiny IDQN train state and its iteration as the host loop runs it
    (the iteration, then its loss read)."""
    cfg = load_config(TINY + [f"device={device}"])
    env, eval_env = build_envs(cfg)
    cfg.algorithm.parallel_envs = int(cfg.env.parallel_envs)
    init_state, train_iteration, _ = dqn.build_train_functions(env, eval_env, cfg.algorithm, 5, torch.device(device))
    state = init_state(0)
    return lambda: dqn_train.read_loss(train_iteration(state))


def test_span_without_a_listener_runs_no_record_function(monkeypatch):
    calls = []
    monkeypatch.setattr(profiling, "record_function", lambda name: calls.append(name))
    step = tiny_iteration()
    step()
    with profiling.span("dqn/sample"):
        pass
    assert calls == [] and profiling.span("env/step") is profiling.span("dqn/updates")


def test_span_under_the_profiler_is_a_range():
    step = tiny_iteration()
    step()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    names = {e.name for e in prof.events()}
    assert {"dqn/rollout", "env/step", "dqn/replay_add", "dqn/updates", "dqn/sample", "dqn/optimizer",
            "sync/rollout_seed", "sync/replay_filled", "sync/loss"} <= names


class FakeClock:
    def __init__(self, *times):
        self.times = iter(times)

    def __call__(self):
        return next(self.times, 0)


def test_host_spans_give_inclusive_self_and_sync_time(monkeypatch):
    """outer [0, 100) holds a sync [10, 30) and a step [40, 45): its self
    time is 100 - 20 - 5, its sync time the sync's 20."""
    monkeypatch.setattr(profiling.time, "perf_counter_ns", FakeClock(0, 10, 30, 40, 45, 100, 200, 260))
    with profiling.host_spans() as spans:
        with profiling.span("dqn/rollout"):
            with profiling.host_sync("sync/rollout_seed"):
                pass
            with profiling.span("env/step"):
                pass
        with profiling.span("dqn/rollout"):
            pass
    ms = 1e-6
    report = spans.report(iters=2)
    assert report["dqn/rollout"] == pytest.approx({"calls": 1.0, "ms": 160 * ms / 2, "self_ms": 135 * ms / 2,
                                                   "sync_ms": 20 * ms / 2})
    assert report["sync/rollout_seed"] == pytest.approx({"calls": 0.5, "ms": 10 * ms, "self_ms": 10 * ms,
                                                         "sync_ms": 10 * ms})
    assert report["env/step"] == pytest.approx({"calls": 0.5, "ms": 2.5 * ms, "self_ms": 2.5 * ms, "sync_ms": 0.0})
    assert profiling.counters() == {"sync/rollout_seed": 1}
    assert profiling.span("env/step") is profiling.span("dqn/sample")  # closed again: the flag check only


def test_host_spans_of_another_thread_are_roots_there():
    """The autograd engine runs a CUDA backward on a thread of its own: a
    span there does not count as a child of the span that waits for it."""
    with profiling.host_spans() as spans:
        with profiling.span("dqn/updates"):
            worker = threading.Thread(target=lambda: profiling.span("gru/backward").__enter__().__exit__(None))
            worker.start()
            worker.join(timeout=10)
        with pytest.raises(RuntimeError, match="already open"):
            with profiling.host_spans():
                pass
    assert not worker.is_alive()
    report = spans.report()
    assert report["gru/backward"]["calls"] == 1
    assert report["dqn/updates"]["self_ms"] == report["dqn/updates"]["ms"]


def test_launch_counts_are_entries_of_the_registry():
    assert fused_gru.launch_counts() == {"fwd": 0, "bwd": 0, "fwd_wide": 0, "bwd_wide": 0, "dw": 0, "reduce": 0}
    profiling.count(fused_gru.LAUNCHES["dw"], 2)
    profiling.count("rollout/policy_steps", 5)
    assert fused_gru.launch_counts()["dw"] == 2
    fused_gru.reset_launch_counts()
    assert fused_gru.launch_counts()["dw"] == 0 and profiling.counters() == {"rollout/policy_steps": 5}
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_recurrence_forward_calls_are_counted_by_shape():
    gen = torch.Generator().manual_seed(0)
    for G, T, B, H in ((2, 1, 4, 16), (2, 1, 4, 16), (3, 6, 2, 8)):
        params = {k: torch.stack([v] * G) for k, v in gru_layer_init(H, H, gen).items()}
        fused_gru.gru_layer_sequence(params, torch.randn(G, T, B, H), torch.zeros(G, B, H))
    assert profiling.counters() == {("gru/forward", (2, 1, 4, 16)): 2, ("gru/forward", (3, 6, 2, 8)): 1}


@pytest.mark.parametrize("early_exit", [True, False])
def test_rollout_counts_its_policy_steps_and_syncs(early_exit):
    T = 120
    env = make_env("lbforaging:Foraging-5x5-2p-1f-v3", time_limit=T)
    steps = []

    def act(carry, obs, mask, generator):
        steps.append(1)
        return carry, D.sample(generator, torch.where(mask > 0, 0.0, float("-inf")))

    collect_episodes(env, act, None, torch.Generator().manual_seed(3), 24, T, early_exit=early_exit)
    counts = profiling.counters()
    assert counts["rollout/policy_steps"] == len(steps) and (len(steps) < T) == early_exit
    # the early exit tests once a step taken, and once more where it stops
    assert counts.get("sync/early_exit", 0) == (len(steps) + 1 if early_exit else 0)
    assert counts["sync/rollout_seed"] == 1


def test_train_iteration_counts_its_syncs_and_recurrence_calls():
    step = tiny_iteration()
    step()
    counts = profiling.counters()
    assert {k: n for k, n in counts.items() if isinstance(k, str)} == {
        "dqn/iterations": 1, "rollout/policy_steps": 5, "env/step_eager": 5, "sync/rollout_seed": 1,
        "sync/replay_filled": 1, "sync/loss": 1}
    # the rollout's 5 steps at T=1; per update the online and target forwards over T+1
    assert {k: n for k, n in counts.items() if isinstance(k, tuple)} == {
        ("gru/forward", (2, 1, 4, 128)): 5, ("gru/forward", (2, 6, 2, 128)): 4}


def test_every_span_is_declared_and_opened():
    """Every name the port passes to `span` or `host_sync` is in `SPANS`,
    every name in `SPANS` is opened somewhere, and `record_function` is
    called only inside `profiling.span`."""
    opened, ranges = set(), []
    for path in PACKAGE.rglob("*.py"):
        text = path.read_text()
        opened |= set(re.findall(r"\b(?:span|host_sync)\(\"([^\"]+)\"\)", text))
        if "record_function(" in text:
            ranges.append(path.relative_to(PACKAGE).as_posix())
    assert opened == set(profiling.SPANS)
    assert len(profiling.SPANS) == len(set(profiling.SPANS))
    assert ranges == ["utils/profiling.py"]
    # the mixer's span is QMIX's alone: the IDQN iteration of the card test below opens none
    assert set(profile.SUB_RANGES) == set(INNER) | {"env/step", "qmix/mixer"}


def test_mixer_span_and_counter_twice_an_update():
    """A QMIX update opens `qmix/mixer` twice, around the online and the
    target mixer, each counted as ("qmix/mixer", (U, T*B, S))."""
    assert "qmix/mixer" in profiling.SPANS
    T, B, updates = 5, 2, 2
    argv = ["+algorithm=qmix", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", f"env.time_limit={T}",
            "env.parallel_envs=4", "algorithm.model.use_rnn=true", f"algorithm.batch_size={B}",
            "algorithm.buffer_size=8", "algorithm.training_start=0", f"algorithm.updates_per_collect={updates}",
            "seed=0", "device=cpu"]
    cfg = load_config(argv)
    env, eval_env = build_envs(cfg)
    cfg.algorithm.parallel_envs = int(cfg.env.parallel_envs)
    init_state, train_iteration, _ = dqn.build_train_functions(env, eval_env, cfg.algorithm, T, torch.device("cpu"))
    state = init_state(0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        dqn_train.read_loss(train_iteration(state))
    assert sum(e.name == "qmix/mixer" for e in prof.events()) == 2 * updates
    mixer_calls = {k: n for k, n in profiling.counters().items() if isinstance(k, tuple) and k[0] == "qmix/mixer"}
    assert mixer_calls == {("qmix/mixer", (1, T * B, sum(env.obs_dims))): 2 * updates}


@pytest.mark.cuda
def test_each_inner_span_holds_device_work_on_the_card(tmp_path, monkeypatch):
    """On the card, in a traced iteration at a small E, each span inside the
    iteration's ranges (the backward's on the autograd engine's thread
    included) has a device-side span that holds at least one operation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the GRU kernels have no CPU mode")
    monkeypatch.chdir(tmp_path)
    report = profile.main(TINY + ["device=cuda", "profile.iters=1", "algorithm.rollout_early_exit=on"])
    held = {name: report["sub_ranges"][name]["kernel_ms_per_iter"] for name in INNER}
    assert all(ms and ms > 0 for ms in held.values()), held
    assert {c["direction"] for c in report["gru_calls_per_iter"]} == {"forward", "backward"}
    assert report["gru_launches_per_iter"]["bwd"] == 2  # one an update
    # every env step a replay of the graph captured in the warm-up, its kernels inside `env/step`
    assert report["env_steps_by_path_per_iter"] == {"graph_captures": 0, "eager": 0,
                                                    "graph_replays": report["policy_steps_per_iter"]}
    assert report["sub_ranges"]["env/step"]["kernel_ms_per_iter"] > 0
