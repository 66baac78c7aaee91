"""The early-exit episode collector against the JAX package's rule: the
`rollout_early_exit` option, `early_termination_possible` of every env and
wrapper, the `auto` rule, and identical rollouts and an identical next draw
of the caller's generator with the early exit on and off."""

from dataclasses import fields

import pytest
import torch

from codebase_tpu.algos.common import early_exit_option as jax_early_exit_option
from codebase_tpu.config import Config as JaxConfig
from codebase_tpu.envs.factory import make_env as jax_make_env
from codebase_tpu_torch.algos.common import early_exit_option
from codebase_tpu_torch.config import Config
from codebase_tpu_torch.envs.factory import make_base_env, make_env
from codebase_tpu_torch.envs.vector import Rollout, collect_episodes
from codebase_tpu_torch.models import distributions as D

torch.set_num_threads(2)


@pytest.mark.parametrize("value", [None, "auto", "on", True, "true", "off", False, "false"])
def test_early_exit_option_matches_jax(value):
    cfg = {} if value is None else {"rollout_early_exit": value}
    assert early_exit_option(Config(cfg)) == jax_early_exit_option(JaxConfig(cfg))


def test_early_exit_option_refuses_other_values():
    with pytest.raises(ValueError, match="auto/on/off"):
        early_exit_option(Config({"rollout_early_exit": "sometimes"}))


ENVS = ["lbforaging:Foraging-8x8-2p-3f-v3", "smaclite:3m-v0", "rware-tiny-2ag-v2", "matrix-climbing-5"]
WRAPPINGS = [dict(), dict(observe_id=True), dict(standardise_rewards=True), dict(wrappers=["CooperativeReward"]),
             dict(observe_id=True, standardise_rewards=True, wrappers=["CooperativeReward"])]


@pytest.mark.parametrize("name", ENVS)
def test_early_termination_possible_for_every_env_and_wrapper(name):
    """RWARE ends only at its horizon; every other env can end early; every
    wrapper passes its env's answer through."""
    expected = not name.startswith("rware")
    assert make_base_env(name).early_termination_possible == expected
    for kw in WRAPPINGS:
        env, jenv = make_env(name, time_limit=25, **kw), jax_make_env(name, time_limit=25, **kw)
        assert env.early_termination_possible == jenv.early_termination_possible == expected


def _random_policy(steps):
    """Uniform over the valid actions, drawing from the rollout's generator;
    counts its calls in `steps`."""

    def act(carry, obs, mask, generator):
        steps.append(1)
        return carry, D.sample(generator, torch.where(mask > 0, 0.0, float("-inf")))

    return act


def _collect(env, E, T, early_exit, seed=3):
    gen = torch.Generator().manual_seed(seed)
    steps = []
    rollout, _ = collect_episodes(env, _random_policy(steps), None, gen, E, T, early_exit=early_exit)
    return rollout, len(steps), torch.rand((4,), generator=gen)


@pytest.mark.parametrize("name,E,T", [("smaclite:3m-v0", 24, 60), ("lbforaging:Foraging-5x5-2p-1f-v3", 24, 120)])
def test_early_exit_gives_identical_rollouts_and_generator_state(name, E, T):
    """With the early exit the loop stops at the first step with no running
    env, fills the steps not taken as finished envs are filled, and the
    caller's generator ends where it would without it: the next draw is
    the same."""
    env = make_env(name, time_limit=T)
    on, steps_on, next_on = _collect(env, E, T, True)
    off, steps_off, next_off = _collect(env, E, T, False)
    assert steps_off == T and steps_on == int(off.episode_lengths.max()) < T
    for f in fields(Rollout):
        assert torch.equal(getattr(on, f.name), getattr(off, f.name)), f.name
    assert torch.equal(next_on, next_off)
    assert torch.equal(on.action_mask[steps_on + 1:], torch.ones_like(on.action_mask[steps_on + 1:]))


@pytest.mark.parametrize("name,E,early", [("lbforaging:Foraging-5x5-2p-1f-v3", 512, True),
                                           ("lbforaging:Foraging-5x5-2p-1f-v3", 511, False),
                                           ("rware-tiny-2ag-v2", 512, False)])
def test_auto_exits_early_for_wide_batches_of_envs_that_can_end(name, E, early):
    """`auto`: E >= 512 and `early_termination_possible`, the JAX rule."""
    T = 120 if name.startswith("lbforaging") else 30
    env = make_env(name, time_limit=T)
    _, steps, _ = _collect(env, E, T, "auto")
    assert (steps < T) == early


@pytest.mark.parametrize("argv", [
    ["+algorithm=qmix", "env.name=smaclite:3m-v0", "env.time_limit=40", "algorithm.model.use_rnn=true",
     "algorithm.total_steps=150", "algorithm.training_start=0", "algorithm.batch_size=4",
     "algorithm.buffer_size=16", "algorithm.eval_interval=1000", "algorithm.log_interval=1000"],
    ["+algorithm=mappo", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=60",
     "algorithm.model.actor.use_rnn=true", "algorithm.total_steps=300", "algorithm.log_interval=1000"],
])
def test_train_runs_are_identical_with_the_early_exit_on_and_off(tmp_path, argv):
    """Both train modules pass `rollout_early_exit` to the collector, and a
    run ends in the same parameters, env-step count and generator state
    with it on and off."""
    from codebase_tpu_torch import run

    ends = []
    for opt in ("on", "off"):
        _, state = run.main(argv + ["env.parallel_envs=4", "seed=1", "device=cpu", f"algorithm.rollout_early_exit={opt}",
                                    f"run_dir={tmp_path / opt}"])
        ends.append((state.model.param_leaves(), state.env_steps, state.generator.get_state()))
    (p_on, n_on, g_on), (p_off, n_off, g_off) = ends
    assert n_on == n_off and torch.equal(g_on, g_off)
    assert all(torch.equal(a, b) for a, b in zip(p_on, p_off))
