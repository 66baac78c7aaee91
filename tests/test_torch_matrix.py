"""The port's batched matrix games against the JAX package's (vmapped over
its scalar step), and IDQN learning the coordination game on the CPU, as
the JAX package's `test_idqn_learns_matrix_coordination` does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codebase_tpu.envs.matrix import parse_matrix_name as jax_parse_matrix_name
from codebase_tpu_torch.algos import dqn
from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.envs.factory import make_env
from codebase_tpu_torch.envs.matrix import PAYOFF_MATRICES, parse_matrix_name

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["matrix-coordination", "matrix-climbing-5", "matrix-penalty-3"])
def test_payoffs_and_termination_match_jax(name):
    """Every joint action, over the episode's length and one step past it."""
    env, jenv = parse_matrix_name(name), jax_parse_matrix_name(name)
    A = env.n_actions
    assert (env.n_agents, env.obs_dim, A, env.episode_length) == (2, 1, jenv.n_actions, jenv.episode_length)
    a = np.stack(np.meshgrid(np.arange(A), np.arange(A), indexing="ij"), -1).reshape(-1, 2)  # (A*A, 2)
    E = len(a)
    jstate, jts = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), E))
    state, ts = env.reset_batch(torch.Generator().manual_seed(0), E)
    for t in range(env.episode_length + 1):
        for k in ("obs", "reward", "stat_reward", "terminated", "truncated", "action_mask"):
            np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(jts, k)), err_msg=f"{k} {t}")
        jstate, jts = jax.vmap(jenv.step)(jstate, jnp.asarray(a, jnp.int32), jax.random.split(jax.random.PRNGKey(t), E))
        state, ts = env.step_batch(state, torch.as_tensor(a))
    table = np.array(PAYOFF_MATRICES[name.split("-")[1]], np.float32)
    np.testing.assert_array_equal(ts.reward.numpy(), np.repeat(table.reshape(-1, 1), 2, 1))
    with pytest.raises(ValueError, match="unknown matrix game"):
        parse_matrix_name("matrix-nosuch")


def test_idqn_learns_matrix_coordination():
    """IDQN must find the (0, 0) joint optimum of the coordination game:
    the JAX package's settings (3000 steps of 16 envs, 12 x 16 iterations),
    mean team return at eps_evaluation above 1.6 of the optimum's 2.0."""
    cfg = load_config(["+algorithm=idqn", "algorithm.total_steps=3000", "algorithm.training_start=64",
                       "algorithm.buffer_size=512", "algorithm.batch_size=32", "algorithm.lr=5e-3",
                       "algorithm.target_update_interval_or_tau=25", "algorithm.eps_decay_over=0.4",
                       "algorithm.eval_episodes=100"])
    cfg.algorithm.parallel_envs = 16
    env = make_env("matrix-coordination", time_limit=1)
    init_state, train_iteration, evaluate = dqn.build_train_functions(env, env, cfg.algorithm, 1, torch.device("cpu"))
    state = init_state(0)
    for _ in range(12 * 16):
        train_iteration(state)
    out = evaluate(state, torch.Generator().manual_seed(1))
    mean_return = float(out["episode_returns"].sum(-1).mean())
    assert mean_return > 1.6, f"IDQN failed to learn coordination: {mean_return}"
