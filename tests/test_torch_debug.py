"""Debug mode of the port (`codebase_tpu_torch/utils/debug.py`, `debug=true`)
against the JAX package's (`codebase_tpu/utils/debug.py`, checkify and
`jax_debug_nans`), on the CPU: the same poisoned params raise a NaN error
in both packages, the port's naming the aten op and its source line; a
clean run's losses are bitwise equal with debug on and off; the loss
sentinel before `training_start` is NaN with debug off and 0.0 with it on,
as in the JAX package; the index and division checks raise before the op;
and a GRU kernel wrapper's scan raises naming the kernel. IDQN and IA2C
(the two families)."""

import functools
import math

import jax
import numpy as np
import pytest
import torch

from codebase_tpu.algos.ac import build_train_functions as jax_build_ac
from codebase_tpu.algos.dqn import build_train_functions as jax_build_dqn
from codebase_tpu.config import load_config as jax_load_config
from codebase_tpu.envs.factory import make_env as jax_make_env
from codebase_tpu_torch.algos import ac, dqn
from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.envs.factory import make_env
from codebase_tpu_torch.ops import kernel_lib
from codebase_tpu_torch.utils import debug
from codebase_tpu_torch.utils.params import tree_leaves

from tests.test_debug import _poison

torch.set_num_threads(2)
CPU = torch.device("cpu")
ENV = "Foraging-5x5-2p-1f-v3"
TOKENS = {
    # tests/test_debug.py's IDQN config, batch 2 so that updates start in the second iteration
    "idqn": ["+algorithm=idqn", "env.parallel_envs=8", "algorithm.total_steps=2000", "algorithm.training_start=0",
             "algorithm.buffer_size=16", "algorithm.batch_size=2"],
    "ia2c": ["+algorithm=ia2c", "env.parallel_envs=8", "algorithm.total_steps=2000"],
}
LATE = ("algorithm.training_start=100000",)  # no update: the loss logged is the sentinel
BUILDERS = {"idqn": (dqn.build_train_functions, jax_build_dqn), "ia2c": (ac.build_train_functions, jax_build_ac)}


def _port(family, debug_on, extra=()):
    cfg = load_config(TOKENS[family] + list(extra))
    env = make_env(ENV, time_limit=5)
    init_state, train_iteration = BUILDERS[family][0](env, env, cfg.algorithm, 5, CPU, debug=debug_on)[:2]
    return init_state(0), train_iteration


@functools.cache
def _jax(family, debug_on, extra=()):
    """The JAX package's initial state and (checkified under debug) train
    chunk, built once per config: the tests share their compiles."""
    cfg = jax_load_config(TOKENS[family] + list(extra))
    cfg.algorithm.parallel_envs = 8
    env = jax_make_env(ENV, time_limit=5)
    _, init_state, train_chunk, _ = BUILDERS[family][1](env, env, cfg.algorithm, 5, debug=debug_on)
    return init_state(jax.random.PRNGKey(0)), train_chunk


@pytest.mark.parametrize("family", ["idqn", "ia2c"])
def test_poisoned_params_raise_a_located_nan_error_in_both_packages(family):
    # the poisoned forward is the rollout's, before any update
    jstate, train_chunk = _jax(family, True, LATE if family == "idqn" else ())
    with pytest.raises(Exception, match="(?i)nan"):
        train_chunk(jstate.replace(params=_poison(jstate.params)), 1)

    state, train_iteration = _port(family, True)
    with torch.no_grad():
        tree_leaves(state.model.param_tree())[0].view(-1)[0] = math.nan  # the leaf JAX's _poison takes
    with pytest.raises(FloatingPointError, match=r"NaN in output 0 .* of aten\.\w+.* at .*\.py:\d+") as err:
        train_iteration(state)
    assert "codebase_tpu_torch" in str(err.value)


@pytest.mark.parametrize("family", ["idqn", "ia2c"])
def test_clean_losses_and_params_are_bitwise_equal_with_debug_on_and_off(family):
    runs = {}
    for debug_on in (False, True):
        state, train_iteration = _port(family, debug_on)
        losses = [float(train_iteration(state)["loss"]) for _ in range(3)]
        runs[debug_on] = (losses, [p.detach().clone() for p in state.model.param_leaves()])
    (off, p_off), (on, p_on) = runs[False], runs[True]
    if family == "idqn":
        assert math.isnan(off[0]) and on[0] == 0.0  # the sentinel of the first, update-less iteration
        off, on = off[1:], on[1:]
    assert all(math.isfinite(v) for v in off) and off == on
    assert all(torch.equal(a, b) for a, b in zip(p_off, p_on))


def test_sentinel_is_nan_without_debug_and_zero_with_it_as_in_jax():
    for debug_on, check in ((False, math.isnan), (True, lambda v: v == 0.0)):
        jstate, train_chunk = _jax("idqn", debug_on, LATE)
        _, metrics = train_chunk(jstate, 1)
        assert all(check(float(v)) for v in np.asarray(metrics["loss"])), debug_on
        state, train_iteration = _port("idqn", debug_on, LATE)
        assert check(float(train_iteration(state)["loss"])), debug_on


def test_index_checks_raise_before_the_op():
    x = torch.arange(12.0).reshape(3, 4)
    with debug.checks():
        with pytest.raises(IndexError, match=r"aten\.gather.*indices span \[0, 4\], allowed \[0, 3\]"):
            torch.gather(x, 1, torch.tensor([[0], [4], [1]]))
        with pytest.raises(IndexError, match="allowed \\[0, 3\\]"):
            torch.gather(x, 1, torch.tensor([[-1], [0], [1]]))
        with pytest.raises(IndexError, match=r"aten\.index\.Tensor"):
            x[torch.tensor([0, 3])]
        x[torch.tensor([0, -3])]  # advanced indexing counts from the end, as in Python
        with pytest.raises(IndexError, match="index_select"):
            x.index_select(0, torch.tensor([5]))
        with pytest.raises(IndexError, match="scatter_add"):
            torch.zeros(3).scatter_add(0, torch.tensor([3]), torch.ones(1))
        with pytest.raises(IndexError, match="take_along_dim"):
            torch.take_along_dim(x, torch.tensor([[4], [0], [0]]), dim=1)  # PyTorch itself wraps this one
        with pytest.raises(IndexError, match=r"index_put"):
            x[torch.tensor([7])] = 1.0
        assert torch.gather(x, 1, torch.tensor([[3], [0], [2]])).flatten().tolist() == [3.0, 4.0, 10.0]


def test_division_checks_raise_before_the_op():
    a, zero = torch.tensor([4, 5]), torch.tensor([2, 0])
    with debug.checks():
        with pytest.raises(ZeroDivisionError, match="floor_divide"):
            a // zero
        with pytest.raises(ZeroDivisionError, match="remainder"):
            a % 0
        with pytest.raises(ZeroDivisionError, match="div"):
            torch.div(a, zero, rounding_mode="trunc")
        assert (a // 2).tolist() == [2, 2] and (a % 3).tolist() == [1, 2]
        assert torch.isinf(a / zero).any()  # a true division makes floats: x / 0 = inf
        with pytest.raises(FloatingPointError, match=r"aten\.div"):
            torch.zeros(2) / torch.zeros(2)  # 0 / 0 = NaN


def test_kernel_outputs_are_scanned_only_in_debug_regions():
    nan = torch.full((2, 3), math.nan)
    kernel_lib.launched("gru_fwd_kernel", {"y": nan}, G=2, T=1, B=3, H=128)  # no region: no check, no sync
    with debug.checks():
        with pytest.raises(FloatingPointError, match=r"gru_bwd_kernel wrote NaN into dgi \(2, 3\) \(G=2 T=1 B=3 H=128\)"):
            kernel_lib.launched("gru_bwd_kernel", {"dgi": nan}, G=2, T=1, B=3, H=128)
        kernel_lib.launched("gru_reduce_kernel", {"out": torch.zeros(2, 3)}, G=2, P=4, E=3)
    assert not debug.active()


def test_the_backward_runs_under_the_mode_and_anomaly_mode():
    """A NaN made in the backward names its aten op (the CPU backward runs
    on the caller's thread, where the dispatch mode is)."""
    w = torch.ones(3, requires_grad=True)
    with debug.checks() as mode:
        y = torch.sqrt(w - 1.0)  # sqrt(0) = 0 forward; its gradient 1 / (2 sqrt(0)) = inf, then * 0 = NaN
        with pytest.raises(FloatingPointError, match=r"NaN in output 0 \(3,\) of aten\.\w+"):
            (y * 0.0).sum().backward()
    assert sum(mode.threads.values()) > 0
