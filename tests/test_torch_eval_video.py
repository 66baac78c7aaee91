"""The port's eval CLI and video: `python -m codebase_tpu_torch.eval` on a
tiny CPU run's directory; `render_frame` of one env of a batched port state
pixel for pixel the JAX package's frame of the same state (LBF, RWARE,
SMAClite 3m, on JAX-reset and JAX-stepped states); `record_episodes`
writing a video (or raw frames without imageio); matrix games refusing to
render in both packages."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lbforaging import to_torch_state as lbf_to_torch
from test_torch_rware import STATE_FIELDS as RWARE_FIELDS
from test_torch_rware import to_torch_state as rware_to_torch
from test_torch_smaclite import to_torch_state as smaclite_to_torch

from codebase_tpu.envs.factory import make_env as jax_make_env
from codebase_tpu_torch import eval as port_eval
from codebase_tpu_torch import run
from codebase_tpu_torch.algos.dqn import DQNModel
from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.envs.factory import make_env
from codebase_tpu_torch.utils.video import record_episodes

torch.set_num_threads(2)
LBF = "lbforaging:Foraging-5x5-2p-1f-v3"
RUN = ["+algorithm=idqn", f"env.name={LBF}", "env.time_limit=5", "env.parallel_envs=4",
       "algorithm.model.use_rnn=true", "algorithm.total_steps=40", "algorithm.training_start=0",
       "algorithm.batch_size=2", "algorithm.buffer_size=8", "algorithm.eval_interval=20",
       "algorithm.save_interval=20", "algorithm.eval_episodes=4", "seed=0", "device=cpu"]


def test_eval_cli_returns_one_return_per_episode(tmp_path):
    run.main(RUN + [f"run_dir={tmp_path}"])
    returns = port_eval.main([f"path={tmp_path}", "eval_episodes=6", "device=cpu", "seed=3"])
    assert returns.shape == (6, 2) and np.isfinite(returns).all()
    latest = max(int(p.stem.split("_s")[-1]) for p in (tmp_path / "checkpoints").glob("model_s*.msgpack"))
    again = port_eval.main([f"path={tmp_path}", "eval_episodes=6", "device=cpu", "seed=3", f"load_step={latest}"])
    np.testing.assert_array_equal(returns, again)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_eval.main([f"path={tmp_path}"])  # the card by default


# (env name, to_torch_state of a JAX batched state, steps)
RENDER = {
    "lbf": ("lbforaging:Foraging-8x8-2p-3f-v3", lbf_to_torch, 30),
    "rware": ("rware-tiny-2ag-v2", lambda js: rware_to_torch({k: np.asarray(getattr(js, k)) for k in RWARE_FIELDS}), 30),
    "smaclite_3m": ("smaclite:3m-v0", smaclite_to_torch, 30),
}


@pytest.mark.parametrize("name", list(RENDER))
def test_render_frame_matches_jax_pixel_for_pixel(name):
    """Three JAX envs reset and stepped with random actions; every few
    steps, each env's frame from the port's render of the batched state
    (index e) equals the JAX render of that env's own state."""
    env_name, to_torch, steps = RENDER[name]
    jenv = jax_make_env(env_name, time_limit=0)
    env = make_env(env_name, time_limit=0)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    states, ts = jax.vmap(jenv.reset)(keys)
    step = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(1)
    checked = 0
    for t in range(steps):
        if t % 5 == 0:
            port_state = to_torch(jenv.to_batch(states))
            for e in range(3):
                one = jax.tree.map(lambda x: x[e], states)
                ref = jenv.render_frame(one)
                got = env.render_frame(port_state, e)
                assert got.dtype == np.uint8 and got.shape == ref.shape
                np.testing.assert_array_equal(got, ref)
                checked += 1
        mask = np.asarray(ts.action_mask)
        actions = (rng.random(mask.shape) * mask).argmax(-1)
        states, ts = step(states, jnp.asarray(actions, jnp.int32), jax.random.split(jax.random.PRNGKey(t + 1), 3))
    assert checked == 3 * (steps // 5)


def test_record_episodes_writes_a_video_or_raw_frames(tmp_path, monkeypatch):
    cfg = load_config(RUN)
    env, _ = run.build_envs(cfg)
    model = DQNModel.create(env, cfg.algorithm.model, cfg.algorithm)
    policy, carry = model.policy(0.05), model.critic.init_hiddens(1)
    out = record_episodes(env, policy, carry, 12, tmp_path / "v.mp4", torch.device("cpu"))
    assert out.exists() and out.stat().st_size > 0 and out.suffix in (".mp4", ".gif", ".npz")
    monkeypatch.setitem(sys.modules, "imageio", None)  # as on a machine without imageio
    out = record_episodes(env, policy, carry, 12, tmp_path / "raw.mp4", torch.device("cpu"))
    assert out.name == "raw.npz"
    frames = np.load(out)["frames"]
    assert frames.shape == (12, 80, 80, 3) and frames.dtype == np.uint8  # 5x5 cells of 16 pixels


def test_matrix_games_do_not_render():
    env = make_env("matrix-climbing-5", time_limit=1)
    state, _ = env.reset_batch(torch.Generator().manual_seed(0), 1)
    with pytest.raises(NotImplementedError, match="does not support rendering"):
        env.render_frame(state, 0)
    jenv = jax_make_env("matrix-climbing-5", time_limit=1)
    with pytest.raises(NotImplementedError, match="does not support rendering"):
        jenv.render_frame(jenv.reset(jax.random.PRNGKey(0))[0])
