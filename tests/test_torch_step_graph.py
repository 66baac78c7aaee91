"""The rollout's env step as a CUDA graph (`envs/step_graph.py`).

On the CPU: the rule that picks the path, what it observes, the eager path
and its counter, and the step into the static inputs (the next state and
mask written back in place) against the eager step, for every env with and
without wrappers. On the card (`cuda`, skipped without one): graphed
rollouts bitwise the eager step loop, one capture per env and width, and
the capture's refusal of a step that moves a counter. This file imports no
JAX, so on the card:

    python -m pytest --noconftest tests/test_torch_step_graph.py -q -m cuda
"""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from codebase_tpu_torch.envs import step_graph
from codebase_tpu_torch.envs.factory import make_env
from codebase_tpu_torch.envs.vector import collect_episodes
from codebase_tpu_torch.envs.wrappers import WrapperBase
from codebase_tpu_torch.models import distributions as D
from codebase_tpu_torch.parallel.mesh import Shard
from codebase_tpu_torch.utils import debug, profiling

torch.set_num_threads(2)
COUNTERS = ("env/step_graph_captures", "env/step_graph_replays", "env/step_eager")
WRAPPED = dict(observe_id=True, standardise_rewards=True, wrappers=["CooperativeReward"])


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.mark.parametrize("device,sharded,watched,graphed", [
    ("cuda", False, False, True),
    ("cuda:0", False, False, True),
    ("cpu", False, False, False),
    ("cuda", True, False, False),
    ("cuda", False, True, False),
    ("cpu", True, True, False),
])
def test_the_rule_graphs_only_an_unsharded_unwatched_cuda_rollout(device, sharded, watched, graphed):
    assert step_graph.graphs_step(torch.device(device), sharded, watched) is graphed


def test_a_dispatch_mode_watches_the_ops():
    assert not step_graph.ops_watched()
    with FlopCounterMode(display=False):
        assert step_graph.ops_watched()
    with debug.checks():
        assert step_graph.ops_watched()
    assert not step_graph.ops_watched()


def _random_policy(steps):
    """Uniform over the valid actions from the rollout's generator; the
    carry folds in each step's observations; counts its calls."""

    def act(carry, obs, mask, generator):
        steps.append(1)
        return carry * 0.5 + obs.sum((1, 2)), D.sample(generator, torch.where(mask > 0, 0.0, float("-inf")))

    return act


def _collect(env, E, T, device="cpu", early_exit="auto", shard=None, seed=3):
    gen = torch.Generator(device=device).manual_seed(seed)
    steps = []
    rollout, carry = collect_episodes(env, _random_policy(steps), torch.zeros(E, device=device), gen, E, T,
                                      early_exit=early_exit, shard=shard)
    return rollout, carry, len(steps), torch.rand((4,), generator=gen, device=device)


def _path_counts():
    counts = profiling.counters()
    return {k: counts.get(k, 0) for k in COUNTERS}


@pytest.mark.parametrize("shard", [None, Shard()])
def test_a_cpu_rollout_counts_only_eager_steps(shard):
    _, _, steps, _ = _collect(make_env("lbforaging:Foraging-5x5-2p-1f-v3", time_limit=40), 24, 40, shard=shard)
    assert _path_counts() == {"env/step_graph_captures": 0, "env/step_graph_replays": 0, "env/step_eager": steps}
    assert profiling.counters()["rollout/policy_steps"] == steps


@pytest.mark.parametrize("wrapped", [False, True])
@pytest.mark.parametrize("name", ["lbforaging:Foraging-8x8-2p-3f-v3", "smaclite:MMM2-v0", "rware-tiny-2ag-v2",
                                  "matrix-climbing-5"])
def test_a_step_into_the_static_inputs_is_the_eager_step(name, wrapped):
    """`_step_into` writes the next state into the state's own tensors and
    the next mask into the mask, as the graph does at its end: from the same
    reset and actions it gives the eager step's `TimeStep`, state and mask,
    bit for bit, step after step."""
    E, T = 32, 30
    env = make_env(name, time_limit=T, **(WRAPPED if wrapped else {}))
    gen_eager, gen_static, gen_actions = (torch.Generator().manual_seed(s) for s in (7, 7, 8))
    state, ts = env.reset_batch(gen_eager, E)
    static, ts_static = env.reset_batch(gen_static, E)
    mask = ts_static.action_mask.clone()
    for _ in range(T):
        actions = D.sample(gen_actions, torch.where(ts.action_mask > 0, 0.0, float("-inf")))
        state, ts = env.step_batch(state, actions, gen_eager, ts.action_mask)
        ts_static = step_graph._step_into(env, static, actions, mask, gen_static)
        for f in dataclasses.fields(ts):
            assert torch.equal(getattr(ts, f.name), getattr(ts_static, f.name)), f.name
        assert all(torch.equal(a, b) for a, b in zip(step_graph._leaves(state), step_graph._leaves(static),
                                                     strict=True))
        assert torch.equal(mask, ts.action_mask)
    assert torch.equal(gen_eager.get_state(), gen_static.get_state())


def test_a_state_with_a_host_value_has_no_static_leaves():
    @dataclasses.dataclass
    class HostState:
        t: int

    with pytest.raises(TypeError):
        step_graph._leaves(HostState(t=0))


# ----------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs have no CPU mode")
    return "cuda"


def _eager(monkeypatch):
    monkeypatch.setattr(step_graph, "graphs_step", lambda *args: False)


@pytest.mark.cuda
@pytest.mark.parametrize("name,E,T,early_exit,wrap", [
    ("lbforaging:Foraging-8x8-2p-3f-v3", 8192, 25, "auto", {}),
    ("lbforaging:Foraging-8x8-2p-3f-v3", 524288, 25, False, {}),
    ("smaclite:MMM2-v0", 1024, 100, True, dict(wrappers=["CooperativeReward"])),
    ("rware-tiny-2ag-v2", 64, 60, "auto", {}),
    ("matrix-climbing-5", 64, 5, "auto", WRAPPED),
])
def test_graphed_rollouts_are_bitwise_the_eager_step_loop(card, monkeypatch, name, E, T, early_exit, wrap):
    """Two graphed rollouts in a row (one capture, every step a replay)
    against the eager step loop from the same seeds: every `Rollout` field,
    the final carry, the steps taken (where the early exit stops) and the
    caller generator's next draw."""
    env = make_env(name, time_limit=T, **wrap)
    graphed = [_collect(env, E, T, card, early_exit, seed=s) for s in (3, 4)]
    counts = _path_counts()
    _eager(monkeypatch)
    eager = [_collect(env, E, T, card, early_exit, seed=s) for s in (3, 4)]
    assert counts == {"env/step_graph_captures": 1, "env/step_graph_replays": graphed[0][2] + graphed[1][2],
                      "env/step_eager": 0}
    for (r_g, c_g, n_g, next_g), (r_e, c_e, n_e, next_e) in zip(graphed, eager):
        assert n_g == n_e
        for f in dataclasses.fields(r_e):
            assert torch.equal(getattr(r_g, f.name), getattr(r_e, f.name)), f.name
        assert torch.equal(c_g, c_e) and torch.equal(next_g, next_e)
    if early_exit is True:
        assert graphed[0][2] < T  # the early exit stopped, at the eager loop's step


@pytest.mark.cuda
def test_each_width_captures_its_own_graph_once(card):
    env = make_env("lbforaging:Foraging-8x8-2p-3f-v3", time_limit=10)
    steps = [_collect(env, E, 10, card, early_exit=False, seed=s)[2] for E, s in ((256, 1), (100, 2), (256, 3))]
    assert _path_counts() == {"env/step_graph_captures": 2, "env/step_graph_replays": sum(steps),
                              "env/step_eager": 0}


@pytest.mark.cuda
def test_a_sharded_or_watched_card_rollout_steps_eagerly(card):
    env = make_env("matrix-climbing-5", time_limit=5)
    _collect(env, 16, 5, card, shard=Shard(device=torch.device(card)))
    with FlopCounterMode(display=False):
        _collect(env, 16, 5, card)
    assert _path_counts() == {"env/step_graph_captures": 0, "env/step_graph_replays": 0, "env/step_eager": 10}


@dataclasses.dataclass(frozen=True)
class _CountingStep(WrapperBase):
    def step_batch(self, state, actions, generator=None, current_mask=None):
        profiling.count("counted/in_the_step")
        return self.env.step_batch(state, actions, generator, current_mask)


@pytest.mark.cuda
def test_the_capture_refuses_a_step_that_moves_a_counter(card):
    env = _CountingStep(make_env("matrix-climbing-5", time_limit=5))
    with pytest.raises(RuntimeError, match="counted/in_the_step"):
        _collect(env, 16, 5, card)
