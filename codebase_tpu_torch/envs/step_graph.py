"""The rollout's env step as a CUDA graph: one capture per env and batch
width, replayed at every step of every later rollout of that width.

Eagerly, `env.step_batch` is a few hundred small operations, each launched
from Python; at the widths the rollout steps on the card the host's launch
loop, not the device, sets the step's pace. A `StepGraph` captures the step
once and replays it with one launch:

- static inputs: the state's tensors, the actions and the current action
  mask; static outputs: the `TimeStep`. The next state and the next mask
  are copied back into the static inputs at the graph's end (one
  multi-tensor copy of their bytes), so the graph
  holds what an eager step holds alive (the state, the `TimeStep`, the
  actions) and one mask more;
- each rollout copies its reset state and mask in, and the graph is kept
  for the env's later rollouts of the same width (`for_env`);
- the first step at a width runs the step once eagerly on copies of the
  inputs (the warm-up, which makes every lazy constant and module load
  before the capture), puts the generator back where it was, captures, and
  replays; every step, the first included, is a replay.

Random draws: the rollout's generator is one object a graph (`StepGraph.
generator`), reseeded at every rollout start, which gives the bits a fresh
generator seeded alike gives. Where the step draws from it (RWARE's new
requests) it is registered with the graph, so each replay draws from its
current offset and moves it on as the eager step would: the policy's eager
draws and the graph's interleave as before, and a rollout is bitwise the
eager one.

The step may read no host value that changes between steps, may not sync,
and no shape in it may depend on data; every env of the port (LBF,
SMAClite, RWARE, the matrix games) and every wrapper keeps to that. A
counter the step moved would not move in a replay, so the capture refuses
a step that moves one.

Counters (`utils/profiling.count`): `env/step_graph_captures`, one a
capture; `env/step_graph_replays` and `env/step_eager`, one a step on the
path it took.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from codebase_tpu_torch.utils import profiling


def graphs_step(device: torch.device, sharded: bool, watched: bool) -> bool:
    """Whether a rollout replays its env step as a CUDA graph: on a CUDA
    device, in a rollout that is no rank's part of a data-parallel one
    (whose draws and early exit are the ranks' together), and while no
    dispatch mode watches the ops (debug mode's checks, an operation count),
    which a replay would pass by."""
    return device.type == "cuda" and not sharded and not watched


def ops_watched() -> bool:
    """A Python dispatch mode is active: it sees every op run eagerly."""
    return _get_current_dispatch_mode() is not None


def eager_steps(env, state):
    """`step(actions, generator, mask) -> TimeStep`, stepping `state` eagerly."""

    def step(actions, generator, mask):
        nonlocal state
        profiling.count("env/step_eager")
        state, ts = env.step_batch(state, actions, generator, mask)
        return ts

    return step


_GRAPHS = {}  # id(env) -> {(E, device): StepGraph}, dropped with the env


def for_env(env, n_envs: int, device: torch.device) -> "StepGraph":
    """The `StepGraph` of `env` at `n_envs` envs on `device`, made at the
    first call and kept while the env lives."""
    graphs = _GRAPHS.get(id(env))
    if graphs is None:
        graphs = _GRAPHS[id(env)] = {}
        weakref.finalize(env, _GRAPHS.pop, id(env), None)
    key = (n_envs, str(device))
    if key not in graphs:
        graphs[key] = StepGraph(device)
    return graphs[key]


def _leaves(state) -> list:
    """The tensors of a state (a tensor or a dataclass of them, nested), in
    field order. A field of any other kind raises: the step would read a
    host value."""
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for f in dataclasses.fields(state) for t in _leaves(getattr(state, f.name))]


def _cloned(state):
    if isinstance(state, torch.Tensor):
        return state.clone(memory_format=torch.contiguous_format)
    return dataclasses.replace(state, **{f.name: _cloned(getattr(state, f.name)) for f in dataclasses.fields(state)})


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _copy(dsts, srcs) -> None:
    """Copy each of `srcs` into the contiguous tensor of `dsts` beside it,
    as bytes in one multi-tensor copy: one launch for the state's tensors of
    every dtype (a tensor onto itself is left out)."""
    pairs = [(d, s) for d, s in zip(dsts, srcs, strict=True) if s is not d]
    if pairs:
        torch._foreach_copy_([_bytes(d) for d, _ in pairs], [_bytes(s) for _, s in pairs])


def _step_into(env, state, actions, mask, generator):
    """One step from `state`, whose tensors then hold the next state and
    `mask` the next mask (an env that masks no action keeps its mask of
    ones); returns the `TimeStep`."""
    nxt, ts = env.step_batch(state, actions, generator, mask)
    masks = env.has_action_mask
    _copy(_leaves(state) + [mask] * masks, _leaves(nxt) + [ts.action_mask] * masks)
    return ts


class StepGraph:
    """One env's step at one batch width, captured at its first step and
    replayed after (see the module's docstring)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.graph = self.ts = None
        self.state = self.mask = self.actions = None  # the static inputs, made at the first rollout

    def start(self, env, state, mask):
        """A rollout from the reset `state` and `mask`: returns its
        `step(actions, generator, mask) -> TimeStep`. The generator is
        `self.generator`, reseeded for the rollout; the mask is the last
        step's, already in the graph."""
        if self.state is None:
            self.state, self.mask = _cloned(state), _cloned(mask)
        else:
            _copy(_leaves(self.state) + [self.mask], _leaves(state) + [mask])

        def step(actions, generator, mask):
            if self.graph is None:
                self._capture(env, actions, generator)
            self.actions.copy_(actions)
            self.graph.replay()
            profiling.count("env/step_graph_replays")
            return self.ts

        return step

    def _capture(self, env, actions, generator):
        before = profiling.counters()
        self.actions = torch.empty_like(actions)
        rng = generator.get_state()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            _step_into(env, _cloned(self.state), actions, _cloned(self.mask), generator)  # the warm-up
        drew = not torch.equal(rng, generator.get_state())
        generator.set_state(rng)
        graph = torch.cuda.CUDAGraph()
        if drew:
            graph.register_generator_state(generator)
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            ts = _step_into(env, self.state, self.actions, self.mask, generator)
        moved = {k for k, n in profiling.counters().items() if before.get(k) != n}
        if moved:
            raise RuntimeError(f"{type(env).__name__}.step_batch moved the counters {sorted(map(str, moved))}, "
                               "which a replay of its graph would not move")
        self.graph, self.ts = graph, ts
        profiling.count("env/step_graph_captures")
