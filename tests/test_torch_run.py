"""Tiny end-to-end training runs of the port on the CPU (`device=cpu`),
recurrent IDQN, recurrent QMIX with reward standardisation and the four
actor-critic presets on LBF, QMIX on SMAClite (and MMM2 with the shared
GRU in bf16), against the JAX
package's runs of the same configs: both write results.csv with the same
header. The host loops' cadence is held to the JAX drivers' on the same
stubbed sequence of iteration steps and losses."""

import csv
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from codebase_tpu import run as jax_run
from codebase_tpu.algos import ac_train as jax_ac_train
from codebase_tpu.algos import dqn_train as jax_dqn_train
from codebase_tpu.config import load_config as jax_load_config
from codebase_tpu_torch import run
from codebase_tpu_torch.algos import ac_train, dqn_train
from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.parallel import mesh

torch.set_num_threads(2)
ARGV = [
    "+algorithm=idqn",
    "env.name=lbforaging:Foraging-5x5-2p-1f-v3",
    "env.time_limit=5",
    "env.parallel_envs=4",
    "algorithm.total_steps=2000",
    "algorithm.training_start=0",
    "algorithm.batch_size=2",
    "algorithm.buffer_size=16",
    "algorithm.eval_interval=500",
    "algorithm.log_interval=500",
    "algorithm.eval_episodes=8",
    "algorithm.model.use_rnn=true",
    "seed=1",
]


def _header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def test_cpu_run_writes_results_with_the_jax_schema(tmp_path):
    defaults = ["resume=null", "debug=false", "trace_dir=null", "distributed.devices=null",
                "distributed.initialize=auto"]
    rows, state = run.main(ARGV + defaults + ["device=cpu", f"run_dir={tmp_path / 'port'}"])
    jax_run.main(ARGV + [f"run_dir={tmp_path / 'jax'}"])
    header = _header(tmp_path / "port" / "results.csv")
    assert header == _header(tmp_path / "jax" / "results.csv")
    assert len(rows) >= 2 and all(math.isfinite(float(r["loss"])) for r in rows)
    assert state.updates > 0 and state.env_steps >= 2000
    assert (tmp_path / "port" / "config.yaml").exists()


def test_entry_point_refuses_what_it_cannot_do(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run.main(ARGV + ["device=cuda", f"run_dir={tmp_path}"])
    # bfloat16 is ported; other model dtypes are refused, as in the JAX package
    with pytest.raises(ValueError, match="choose float32 or bfloat16"):
        run.main(["+algorithm=ia2c", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5",
                  "algorithm.model.actor.dtype=float16", "device=cpu", f"run_dir={tmp_path}"])
    with pytest.raises(ValueError, match="unknown algorithm 'nosuch'"):
        run.main(["+algorithm=nosuch", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5",
                  "device=cpu", f"run_dir={tmp_path}"])
    # the tooling keys are ported (no key of the JAX package is refused any
    # longer): debug trains under the checks, trace_dir writes a trace, and
    # algorithm.entry dispatches to the user's entry point (an import error
    # names the module it could not find)
    short = ["algorithm.total_steps=100", "algorithm.eval_interval=50", "algorithm.log_interval=50"]
    rows, _ = run.main(ARGV + ["device=cpu", "debug=true", *short, f"run_dir={tmp_path / 'debug'}"])
    assert rows and all(math.isfinite(float(r["loss"])) for r in rows if r.get("loss"))
    run.main(ARGV + ["device=cpu", f"trace_dir={tmp_path / 'traces'}", *short, f"run_dir={tmp_path / 'traced'}"])
    assert list((tmp_path / "traces").glob("*.pt.trace.json"))
    with pytest.raises(ModuleNotFoundError, match="my_pkg"):
        run.main(ARGV + ["device=cpu", "algorithm.entry=my_pkg.algo:main", f"run_dir={tmp_path}"])
    with pytest.raises(ValueError, match=r"unknown config keys \['distributed.hosts'\]"):
        run.main(ARGV + ["device=cpu", "distributed.hosts=4", f"run_dir={tmp_path}"])
    # the multi-GPU keys are ported (parallel/mesh.py): each builds its group.
    # distributed.devices=2 spawns two ranks over gloo on the CPU ...
    spawned, joined = [], []
    spawn, init = mesh.spawn, mesh.init
    monkeypatch.setattr(mesh, "spawn", lambda fn, world, *a, **k: spawned.append(world) or spawn(fn, world, *a, **k))
    monkeypatch.setattr(mesh, "init", lambda *a, **k: joined.append(a[:2]) or init(*a, **k))
    rows, _ = run.main(ARGV + ["device=cpu", "distributed.devices=2", *short, f"run_dir={tmp_path / 'devices2'}"])
    assert spawned == [2] and rows
    # ... and distributed.initialize=always joins torchrun's group (here a
    # job of one rank) from its variables
    for var, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "0")):
        monkeypatch.setenv(var, value)
    rows, state = run.main(ARGV + ["device=cpu", "distributed.initialize=always", "distributed.devices=all", *short,
                                   f"run_dir={tmp_path / 'always'}"])
    assert joined == [(0, 1)] and state.shard.world == 1 and rows
    assert not torch.distributed.is_initialized()
    # checkpoints and videos are ported: both intervals run on the CPU
    run.main(ARGV + ["device=cpu", "algorithm.total_steps=100", "algorithm.save_interval=50",
                     "algorithm.video_interval=50", "algorithm.video_frames=4", f"run_dir={tmp_path / 'saved'}"])
    assert sorted((tmp_path / "saved" / "checkpoints").glob("model_s*.msgpack"))
    assert sorted((tmp_path / "saved" / "videos").glob("step-*"))


def test_cpu_qmix_run_with_standardisation_writes_the_jax_schema(tmp_path):
    """The QMIX preset as it is (CooperativeReward above the reward
    standardiser) with reward standardisation on: the run trains with finite
    losses, its reward streams advance, and results.csv has the JAX run's
    header. (Return standardisation is held to the JAX loss in
    test_torch_dqn.py; from a fresh target net it diverges in both packages,
    see test_mixed_return_standardisation_diverges_from_init_in_both_packages.)"""
    argv = ["+algorithm=qmix", "env.standardise_rewards=true", "algorithm.model.parameter_sharing=true"] + ARGV[1:]
    rows, state = run.main(argv + ["device=cpu", f"run_dir={tmp_path / 'port'}"])
    jax_run.main(argv + [f"run_dir={tmp_path / 'jax'}"])
    assert _header(tmp_path / "port" / "results.csv") == _header(tmp_path / "jax" / "results.csv")
    assert len(rows) >= 2 and all(math.isfinite(float(r["loss"])) for r in rows)
    assert state.model.mixer is not None and state.updates > 0
    assert float(state.reward_stream.n.min()) > 0


AC_ARGV = [
    "env.name=lbforaging:Foraging-5x5-2p-1f-v3",
    "env.time_limit=5",
    "env.parallel_envs=4",
    "algorithm.total_steps=100",
    "algorithm.log_interval=40",
    "seed=1",
]


@pytest.mark.parametrize("algo,rnn", [("ia2c", False), ("maa2c", False), ("ippo", False), ("mappo", True)])
def test_cpu_ac_runs_write_the_jax_schema(tmp_path, algo, rnn):
    """Each actor-critic preset trains on the CPU with finite losses and
    writes the JAX run's results.csv header; MAPPO with a recurrent actor
    and a recurrent centralised critic."""
    argv = [f"+algorithm={algo}"] + AC_ARGV
    if rnn:
        argv += ["algorithm.model.actor.use_rnn=true", "algorithm.model.critic.use_rnn=true"]
    rows, state = run.main(argv + ["device=cpu", f"run_dir={tmp_path / 'port'}"])
    jax_run.main(argv + [f"run_dir={tmp_path / 'jax'}"])
    assert _header(tmp_path / "port" / "results.csv") == _header(tmp_path / "jax" / "results.csv")
    assert rows and all(math.isfinite(float(r[k])) for r in rows for k in ("loss", "value_loss", "entropy"))
    # one update per iteration; each iteration steps every env for the longest episode
    assert state.updates == len(state.timings) and state.env_steps >= 100
    assert state.model.actor.use_rnn == state.model.critic.use_rnn == rnn


def test_cpu_qmix_run_on_smaclite_writes_the_jax_schema(tmp_path):
    """The QMIX preset on smaclite:3m (masks, f32 replay) trains on the CPU
    with finite losses and writes the JAX run's results.csv header."""
    argv = ["+algorithm=qmix", "env.name=smaclite:3m-v0", "env.time_limit=20", "env.parallel_envs=4",
            "algorithm.total_steps=300", "algorithm.training_start=0", "algorithm.batch_size=4",
            "algorithm.buffer_size=16", "algorithm.eval_interval=100", "algorithm.log_interval=100",
            "algorithm.eval_episodes=4", "algorithm.updates_per_collect=2", "seed=1"]
    rows, state = run.main(argv + ["device=cpu", f"run_dir={tmp_path / 'port'}"])
    jax_run.main(argv + [f"run_dir={tmp_path / 'jax'}"])
    assert _header(tmp_path / "port" / "results.csv") == _header(tmp_path / "jax" / "results.csv")
    assert rows and all(math.isfinite(float(r["loss"])) for r in rows if r.get("loss"))
    assert state.buffer.obs.dtype == torch.float32 and state.buffer.action_mask is not None


@pytest.mark.parametrize("argv", [
    ["+algorithm=idqn", "env.name=rware-tiny-2ag-v2", "env.time_limit=25", "algorithm.training_start=0",
     "algorithm.batch_size=2", "algorithm.buffer_size=8", "algorithm.total_steps=200"],
    ["+algorithm=vdn", "env.name=matrix-climbing-5", "env.time_limit=5", "algorithm.training_start=0",
     "algorithm.batch_size=2", "algorithm.buffer_size=8", "algorithm.total_steps=100"],
    ["+algorithm=mappo", "env.name=smaclite:3m-v0", "env.time_limit=20", "algorithm.model.actor.use_rnn=true",
     "algorithm.model.critic.use_rnn=true", "algorithm.total_steps=200"],
], ids=["idqn-rware", "vdn-matrix", "mappo-smaclite-rnn"])
def test_cpu_runs_on_rware_matrix_and_smaclite(tmp_path, argv):
    """The new envs through the entry point on the CPU: finite losses in
    every row, and steps advanced past total_steps."""
    argv = argv + ["env.parallel_envs=4", "algorithm.eval_interval=50", "algorithm.log_interval=50",
                   "algorithm.eval_episodes=4", "seed=2", "device=cpu", f"run_dir={tmp_path}"]
    rows, state = run.main(argv)
    assert rows and all(math.isfinite(float(r["loss"])) for r in rows if r.get("loss"))
    assert state.env_steps > int(next(a for a in argv if "total_steps" in a).split("=")[1])


# ---------------------------------------------------------------- cadence
# Both drivers run on stubbed train functions: iteration k advances the env
# steps by steps[k] and reports losses[k] (nan: no update yet), so rows, the
# stopping step and the logged losses depend on the loop alone.

E, N, T = 4, 2, 5
LOSSES = [math.nan, math.nan] + [0.5 * k + 0.25 for k in range(2, 400)]
LOSSES[7] = math.nan  # a nan inside a chunk: the nan-mean skips it
STEPS = {
    "full": [E * T] * 400,
    # full episodes, then short ones (AC steps are t_max * E, DQN's filled
    # steps any count; multiples of E suit both)
    "short": [E * T] * 2 + [E * t for t in (3, 1, 4, 2, 5, 2, 3, 1, 1, 2)] * 40,
}
CASES = {  # ROADMAP Queue 3's cases: IA2C total 200 / log 50; IDQN total 400 / eval 50
    "ia2c": ["algorithm.total_steps=200", "algorithm.log_interval=50"],
    "idqn": ["algorithm.total_steps=400", "algorithm.eval_interval=50", "algorithm.log_interval=50"],
}


class _RowLogger:
    def __init__(self):
        self.rows = []

    def log_metrics(self, infos):
        counters = next(i for i in infos if "environment_steps" in i)
        loss = next((i for i in infos if "loss" in i), {})
        self.rows.append({**counters, **loss, "episodes": sum("episode_length" in i for i in infos)})

    def watch(self, model):
        pass

    info = warning = watch


def _jax_stub(steps, family):
    def build(env, eval_env, acfg, time_limit, mesh=None, debug=False):
        def init_state(key):
            return SimpleNamespace(env_steps=0, updates=0, params=None, k=0)

        def train_chunk(state, n):
            ks = range(state.k, state.k + n)
            out = SimpleNamespace(env_steps=state.env_steps + sum(steps[k] for k in ks), updates=state.updates + n,
                                  params=None, k=state.k + n)
            metrics = {"loss": np.array([LOSSES[k] for k in ks], np.float32),
                       "episode_returns": np.zeros((n, E, N), np.float32), "episode_lengths": np.ones((n, E))}
            if family == "ac":
                metrics.update({m: metrics["loss"] for m in ("actor_loss", "value_loss", "entropy")})
            return out, metrics

        def evaluate(params, key):
            return {"episode_returns": np.zeros((3, N), np.float32), "episode_lengths": np.ones(3)}

        return None, init_state, train_chunk, evaluate

    return build


def _port_stub(steps, family):
    def build(env, eval_env, acfg, time_limit, device, shard=None, debug=False):
        def init_state(seed):
            return SimpleNamespace(env_steps=0, updates=0, model=None, timings=[], k=0)

        def train_iteration(state):
            state.env_steps += steps[state.k]
            loss = torch.tensor(LOSSES[state.k])
            state.k += 1
            state.updates += 1
            out = {"loss": loss, "episode_returns": torch.zeros(E, N), "episode_lengths": torch.ones(E)}
            if family == "ac":
                out.update({m: loss for m in ("actor_loss", "value_loss", "entropy")})
            return out

        def evaluate(state, generator):
            return {"episode_returns": torch.zeros(3, N), "episode_lengths": torch.ones(3)}

        return (init_state, train_iteration, evaluate) + ((None,) if family == "ac" else ())

    return build


@pytest.mark.parametrize("sequence", sorted(STEPS))
@pytest.mark.parametrize("algo", sorted(CASES))
def test_rows_and_stop_follow_the_jax_chunk_rule(monkeypatch, algo, sequence):
    """The port's host loop against the JAX package's `main` on the same
    step sequence: the same results.csv rows (environment_steps, updates,
    the DQN loss averaged over the last chunk only, eval episodes) and the
    same stopping step. With E=4, T=5 the chunk is 2 iterations."""
    family = "ac" if algo == "ia2c" else "dqn"
    steps = STEPS[sequence]
    jax_main, port_main = (jax_ac_train, ac_train) if family == "ac" else (jax_dqn_train, dqn_train)
    monkeypatch.setattr(jax_main, "build_train_functions", _jax_stub(steps, family))
    monkeypatch.setattr(port_main, "build_train_functions", _port_stub(steps, family))
    argv = [f"+algorithm={algo}", "seed=0"] + CASES[algo]
    jcfg, cfg = jax_load_config(argv), load_config(argv)
    jcfg.algorithm.parallel_envs = cfg.algorithm.parallel_envs = E
    jlog, log = _RowLogger(), _RowLogger()
    jstate = jax_main.main(None, None, jlog, T, jcfg)
    state = port_main.main(None, None, log, T, cfg, torch.device("cpu"))
    assert [r["environment_steps"] for r in log.rows] == [r["environment_steps"] for r in jlog.rows]
    assert state.env_steps == int(jax.device_get(jstate.env_steps)) and state.k == jstate.k
    assert len(state.timings) == state.k
    for got, ref in zip(log.rows, jlog.rows):
        assert got.keys() == ref.keys() and got["updates"] == ref["updates"] and got["episodes"] == ref["episodes"]
        if "loss" in ref:
            assert got["loss"] == pytest.approx(ref["loss"], rel=1e-6, nan_ok=True)
    assert len(log.rows) >= 3 and any("loss" in r for r in log.rows)


@pytest.mark.parametrize("algo", ["qmix", "mappo"])
def test_cpu_mmm2_runs_with_the_shared_gru_in_bf16(tmp_path, algo):
    """The MMM2 lanes' model (10 allies of three unit types, one shared GRU
    network, `model.dtype=bfloat16`) at a tiny size: the port's run trains
    with finite losses through the kernel route (H=128 here; the card runs
    H=512) and writes the JAX run's header."""
    argv = [f"+algorithm={algo}", "env.name=smaclite:MMM2-v0", "env.time_limit=8", "env.parallel_envs=2",
            "algorithm.total_steps=20", "algorithm.log_interval=10", "algorithm.eval_interval=10",
            "algorithm.eval_episodes=2"]
    if algo == "qmix":
        argv += ["algorithm.model.use_rnn=true", "algorithm.model.parameter_sharing=true",
                 "algorithm.model.dtype=bfloat16", "algorithm.batch_size=2", "algorithm.buffer_size=4",
                 "algorithm.training_start=0", "algorithm.updates_per_collect=2"]
    else:
        argv += [f"algorithm.model.{p}.{k}={v}" for p in ("actor", "critic")
                 for k, v in (("use_rnn", "true"), ("parameter_sharing", "true"), ("dtype", "bfloat16"))]
    rows, state = run.main(argv + ["seed=1", "device=cpu", f"run_dir={tmp_path / 'port'}"])
    jax_run.main(argv + [f"run_dir={tmp_path / 'jax'}"])
    assert _header(tmp_path / "port" / "results.csv") == _header(tmp_path / "jax" / "results.csv")
    nets = [state.model.critic] if algo == "qmix" else [state.model.actor, state.model.critic]
    for net in nets:
        assert net.n_agents == 10 and net.n_groups == 1
        assert (net.spec.compute_dtype, net.spec.route) == ("bfloat16", "kernel_resident")
    assert rows and all(math.isfinite(float(r["loss"])) for r in rows if r.get("loss"))
    assert all(torch.isfinite(p).all() for p in state.model.param_leaves())
