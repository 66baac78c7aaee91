"""Two OS processes with torchrun's variables form one job: the port's
counterpart of `tests/test_multihost.py`.

Each process runs the train CLI (`python -m codebase_tpu_torch.run`) with
`distributed.initialize=always distributed.devices=all device=cpu` and
its own `run_dir`; `RANK`, `WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT`
make them ranks 0 and 1 of one gloo group, as torchrun would. Only rank 0
writes files; a SIGTERM to one rank checkpoints and stops both with rc 0.
Every wait has a timeout that kills both processes.
"""

import csv
import math
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ARGV = ["+algorithm=idqn", "env.name=lbforaging:Foraging-8x8-2p-3f-v3", "env.time_limit=25",
        "env.parallel_envs=8", "seed=0", "algorithm.training_start=100", "algorithm.buffer_size=64",
        "algorithm.batch_size=8", "algorithm.updates_per_collect=2", "algorithm.eval_episodes=8",
        "distributed.devices=all", "distributed.initialize=always", "device=cpu"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(run_dirs, extra):
    """Rank r trains in `run_dirs[r]` (the same dir for a shared one); its
    output goes to `<tmp>/rank<r>_<n>.log`."""
    port = _free_port()
    procs = []
    tmp = run_dirs[0].parent
    for rank, run_dir in enumerate(run_dirs):
        env = dict(os.environ, PYTHONPATH=str(REPO), RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="2")
        log = tmp / f"rank{rank}_{len(list(tmp.glob(f'rank{rank}_*.log')))}.log"
        p = subprocess.Popen([sys.executable, "-m", "codebase_tpu_torch.run", *ARGV, *extra, f"run_dir={run_dir}"],
                             env=env, cwd=tmp, stdout=open(log, "w"), stderr=subprocess.STDOUT)
        p.log = log
        procs.append(p)
    return procs


def _wait(procs, timeout=300):
    """Each process's output once both have ended; kills both on a timeout."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [p.log.read_text() for p in procs]


def test_two_processes_train_and_only_rank_0_writes(tmp_path):
    run_dirs = [tmp_path / "run_rank0", tmp_path / "run_rank1"]
    outs = _wait(_launch(run_dirs, ["algorithm.total_steps=2000", "algorithm.eval_interval=1000",
                                    "algorithm.log_interval=1000", "algorithm.save_interval=1000"]))
    for rank, out in enumerate(outs):
        assert f"rank {rank}/2 joined a gloo group on cpu" in out, out[-3000:]
    res = run_dirs[0] / "results.csv"
    assert res.exists(), outs[0][-3000:]
    assert (run_dirs[0] / "config.yaml").exists()
    assert list((run_dirs[0] / "checkpoints").glob("model_s*.msgpack"))
    assert not run_dirs[1].exists(), "rank 1 wrote files"
    rows = list(csv.DictReader(open(res)))
    losses = [float(r["loss"]) for r in rows if r.get("loss")]
    assert losses and all(math.isfinite(v) for v in losses), rows
    assert all(r.get("mean_episode_returns") for r in rows)


def test_sigterm_to_one_rank_saves_and_stops_both(tmp_path):
    """SIGTERM to rank 1 only, after rank 0's first results.csv row: both
    agree on the flag at the chunk boundary, checkpoint (rank 0 writes) and
    exit 0; relaunched with `resume=auto` on their shared run dir, both
    continue from that checkpoint."""
    run_dirs = [tmp_path / "run", tmp_path / "run"]
    extra = ["algorithm.total_steps=1000000", "algorithm.log_interval=200", "algorithm.eval_interval=200"]
    procs = _launch(run_dirs, extra)
    res = run_dirs[0] / "results.csv"
    deadline = time.time() + 240
    try:
        while not (res.exists() and len(res.read_text().splitlines()) >= 2):
            assert time.time() < deadline and all(p.poll() is None for p in procs), "no first row"
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGTERM)
    finally:
        outs = _wait(procs)
    assert [p.returncode for p in procs] == [0, 0], [o[-3000:] for o in outs]
    assert "SIGTERM received: checkpointing" in outs[0]
    saved = list((run_dirs[0] / "checkpoints").glob("model_s*.msgpack"))
    assert len(saved) == 1
    step = int(saved[0].stem.split("_s")[-1])
    outs = _wait(_launch(run_dirs, ["algorithm.total_steps=" + str(step + 200), "algorithm.log_interval=200",
                                    "algorithm.eval_interval=200", "resume=auto"]))
    for out in outs:
        assert f"Resumed from {saved[0]} at step {step}" in out, out[-3000:]
