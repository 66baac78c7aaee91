"""Preemption-safe auto-resume of the port, as `tests/test_preemption.py`
holds the JAX package to it: SIGTERM mid-run makes `codebase_tpu_torch.run`
checkpoint the full train state after the chunk in flight and exit with
rc 0; relaunching with `resume=auto` continues from the saved step."""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

ARGS = [
    "+algorithm=idqn",
    "env.name=lbforaging:Foraging-5x5-2p-1f-v3",
    "env.time_limit=5",
    "env.parallel_envs=4",
    "algorithm.model.use_rnn=true",
    "algorithm.training_start=0",
    "algorithm.batch_size=2",
    "algorithm.buffer_size=16",
    "algorithm.eval_interval=1000",
    "seed=1",
    "device=cpu",
    "resume=auto",
]


def _launch(run_dir, total_steps):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "2"
    return subprocess.Popen(
        [sys.executable, "-m", "codebase_tpu_torch.run"]
        + ARGS
        + [f"run_dir={run_dir}", f"algorithm.total_steps={total_steps}"],
        env=env,
        cwd=run_dir.parent,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )


def test_sigterm_checkpoints_and_resume_auto_continues(tmp_path):
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    ckpt_dir = run_dir / "checkpoints"

    # a long run, preempted once training is underway: the guard is armed
    # around the training loop, so wait for the first results.csv row
    p = _launch(run_dir, total_steps=50_000_000)
    deadline = time.time() + 300
    try:
        while not (run_dir / "results.csv").exists():
            assert p.poll() is None, "trainer exited before logging"
            assert time.time() < deadline, "training never produced a log row"
            time.sleep(0.2)
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=180)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 0, out[-3000:]
    assert "SIGTERM received: checkpointing at step" in out, out[-3000:]
    ckpts = list(ckpt_dir.glob("model_s*.msgpack"))
    assert ckpts, "SIGTERM produced no checkpoint"
    saved_step = max(int(c.stem.split("_s")[-1]) for c in ckpts)
    assert saved_step > 0

    # relaunch with resume=auto: continues from the saved step
    p2 = _launch(run_dir, total_steps=saved_step + 1200)
    out2, _ = p2.communicate(timeout=300)
    assert p2.returncode == 0, out2[-3000:]
    assert f"Resumed from {ckpt_dir}/model_s{saved_step}.msgpack at step {saved_step}" in out2, out2[-3000:]
    steps = [int(line.split(",")[0]) for line in (run_dir / "results.csv").read_text().splitlines()[1:]]
    assert steps == sorted(steps) and steps[-1] > saved_step
