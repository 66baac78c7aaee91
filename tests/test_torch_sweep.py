"""The port's sweep (`codebase_tpu_torch/sweep.py`, the units of a group in
one train state) on the CPU:

- unit independence: a two-unit train iteration, then the same with unit
  1's lr or seed changed, leaves everything of unit 0 bitwise equal
  (params, target, Adam moments, replay rows, counters, loss, returns and
  return moments), for recurrent IDQN, QMIX with return standardisation
  and recurrent MAPPO: no norm, mean, moment or concatenation crosses
  units;
- a one-unit sweep is `codebase_tpu_torch.run`: the same first weights,
  and the same results.csv rows, bit for bit, in the columns both write;
- the JAX package's layout: the same relative unit paths, the same
  per-unit settings in config.yaml and the same results.csv header as
  `codebase_tpu.sweep.run_vmapped_multiseed` on the same config, for an
  lr grid and for gamma/tau variants folded into one group;
- refusals: a tau set across both target regimes (ValueError),
  `distributed.*` (NotImplementedError naming ROADMAP.md Queue 1 item 6),
  and a checkpoint of a state of several units.
"""

import csv

import numpy as np
import pytest
import torch
import yaml

from codebase_tpu_torch import run as port_run
from codebase_tpu_torch import sweep as port_sweep
from codebase_tpu_torch.algos import ac, dqn
from codebase_tpu_torch.algos.common import unit_values
from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.parallel import mesh

torch.set_num_threads(2)
CPU = torch.device("cpu")
LBF = ["env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5", "device=cpu"]
CASES = {
    "idqn_gru": (dqn, ["+algorithm=idqn", "algorithm.model.use_rnn=true", "algorithm.training_start=0",
                       "algorithm.batch_size=2", "algorithm.buffer_size=8"]),
    "qmix_std": (dqn, ["+algorithm=qmix", "algorithm.model.layers=[16,16]", "algorithm.standardise_returns=true",
                       "algorithm.training_start=0", "algorithm.batch_size=2", "algorithm.buffer_size=8",
                       "algorithm.updates_per_collect=2", "algorithm.target_update_interval_or_tau=0.2"]),
    "mappo_gru": (ac, ["+algorithm=mappo", "algorithm.model.actor.use_rnn=true",
                       "algorithm.model.critic.use_rnn=true", "algorithm.num_epochs=2"]),
}
E = 4


def _same(a, b) -> bool:
    """Bitwise equal, NaN equal to NaN."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _unit0(family, state, metrics):
    """Everything of unit 0 (of 2) in a train state and its last metrics."""
    out = {}
    nets = {"params": state.model.param_leaves(), "mu": state.opt.mu, "nu": state.opt.nu}
    nets["target"] = (state.target if family is dqn else state.target_critic).param_leaves()
    for name, leaves in nets.items():
        for i, leaf in enumerate(leaves):
            out[f"{name}/{i}"] = leaf.detach().reshape(2, -1)[0].clone()
    for f in ("mean", "var", "count"):
        out[f"ret_rms/{f}"] = getattr(state.ret_rms, f)[0].clone()
    for f in ("env_steps", "updates") + (("last_target_update",) if family is dqn else ()):
        out[f] = torch.tensor(unit_values(getattr(state, f), 2)[0])
    out["opt/count"] = torch.tensor(unit_values(state.opt.count, 2)[0])
    if family is dqn:
        buf = state.buffer
        for f in ("obs", "actions", "rewards", "dones", "filled"):
            out[f"replay/{f}"] = getattr(buf, f)[: buf.size].clone()
        out["replay/pos"] = torch.tensor(buf.pos)
    out["loss"] = metrics["loss"].reshape(2)[0]
    out["returns"] = metrics["episode_returns"][:E].clone()
    out["lengths"] = metrics["episode_lengths"][:E].clone()
    return out


def _train(family, argv, hypers, seeds, iters=2):
    cfg = load_config(argv + LBF)
    cfg.algorithm.parallel_envs = E
    env, _ = port_run.build_envs(cfg)
    init_state, train_iteration = family.build_train_functions(env, env, cfg.algorithm, 5, CPU, hypers=hypers)[:2]
    state = init_state(seeds)
    for _ in range(iters):
        metrics = train_iteration(state)
    return _unit0(family, state, metrics), state


@pytest.mark.parametrize("change", ["lr", "seed"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_a_unit_does_not_depend_on_the_other_units(case, change):
    family, argv = CASES[case]
    base, state_a = _train(family, argv, [{"lr": 3e-4}, {"lr": 1e-3}], [0, 1])
    if change == "lr":
        other, state_b = _train(family, argv, [{"lr": 3e-4}, {"lr": 5e-2}], [0, 1])
    else:
        other, state_b = _train(family, argv, [{"lr": 3e-4}, {"lr": 1e-3}], [0, 7])
    assert set(base) == set(other)
    differ = [k for k in base if not _same(base[k], other[k])]
    assert not differ, f"unit 0 changed with unit 1's {change}: {differ}"
    # unit 1 itself did change: the test compares two different groups
    p_a = state_a.model.param_leaves()[0].detach().reshape(2, -1)[1]
    p_b = state_b.model.param_leaves()[0].detach().reshape(2, -1)[1]
    assert not torch.equal(p_a, p_b)
    assert float(base["updates"]) > 0


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_one_unit_sweep_is_the_run_cli(tmp_path):
    """A sweep of one seed and no variants: the first weights are the run's,
    and every results.csv row equals the run's in the columns both write
    (the run's rows also hold `epsilon`)."""
    argv = ["+algorithm=idqn", "algorithm.model.use_rnn=true", "algorithm.training_start=0",
            "algorithm.batch_size=2", "algorithm.buffer_size=8", "algorithm.total_steps=100",
            "algorithm.eval_interval=40", "algorithm.log_interval=40", "algorithm.eval_episodes=3",
            "env.parallel_envs=4", *LBF]
    cfg = load_config(argv)
    units, state, _, _ = port_sweep.build_group(cfg, [3])
    rows, solo = port_run.main(argv + ["seed=3", f"run_dir={tmp_path / 'run'}"])
    fresh = dqn.build_train_functions(*port_run.build_envs(cfg), cfg.algorithm, 5, CPU)[0](3)
    assert units == [(0, 3)] and all(torch.equal(a, b) for a, b in zip(state.model.param_leaves(),
                                                                        fresh.model.param_leaves()))
    (unit_dir,) = port_sweep.run_vmapped_multiseed(load_config(argv), [3], tmp_path / "sweep")
    sweep_rows = _rows(unit_dir / "results.csv")
    assert len(sweep_rows) == len(rows) >= 2
    common = set(rows[0]) & set(sweep_rows[0])
    assert {"environment_steps", "updates", "loss", "mean_episode_returns"} <= common
    for a, b in zip(rows, sweep_rows):
        assert {k: a[k] for k in common} == {k: b[k] for k in common}
    assert yaml.safe_load((unit_dir / "config.yaml").read_text())["seed"] == 3


MATRIX = ["+algorithm=idqn", "env.name=matrix-coordination", "env.time_limit=1", "algorithm.total_steps=600",
          "algorithm.training_start=32", "algorithm.buffer_size=256", "algorithm.batch_size=16",
          "algorithm.eval_interval=200", "algorithm.eval_episodes=8"]


@pytest.mark.parametrize("variants", [
    [{"lr": 3e-4}, {"lr": 1.0}],
    [{"gamma": 0.9, "tau": 100}, {"gamma": 0.5, "tau": 300}],
])
def test_unit_dirs_configs_and_header_follow_the_jax_sweep(tmp_path, variants):
    from codebase_tpu.config import load_config as jax_load_config
    from codebase_tpu.sweep import run_vmapped_multiseed as jax_run_vmapped_multiseed

    jcfg, cfg = jax_load_config(MATRIX), load_config(MATRIX + ["device=cpu"])
    jcfg.algorithm.parallel_envs = cfg.algorithm.parallel_envs = 8
    jdirs = jax_run_vmapped_multiseed(jcfg, [0, 1], tmp_path / "jax", hyper_variants=variants)
    dirs = port_sweep.run_vmapped_multiseed(cfg, [0, 1], tmp_path / "port", hyper_variants=variants)
    assert [d.relative_to(tmp_path / "port") for d in dirs] == [d.relative_to(tmp_path / "jax") for d in jdirs]
    assert len(dirs) == 4
    for d, jd in zip(dirs, jdirs):
        saved, jsaved = (yaml.safe_load((x / "config.yaml").read_text()) for x in (d, jd))
        # the defaults files differ in their top-level keys (the port's
        # device; the JAX package's project name and the keys the port
        # refuses when set); the settings of the unit are the same
        assert saved["device"] == "cpu"
        for k in ("seed", "algorithm", "env"):
            assert saved[k] == jsaved[k], k
        header, jheader = ((x / "results.csv").read_text().splitlines()[0] for x in (d, jd))
        assert header == jheader
        assert len(_rows(d / "results.csv")) == len((jd / "results.csv").read_text().splitlines()) - 1 >= 2


def test_refusals(tmp_path):
    cfg = load_config(MATRIX + ["device=cpu"])
    cfg.algorithm.parallel_envs = 8
    with pytest.raises(ValueError, match="regime"):
        port_sweep.run_vmapped_multiseed(cfg, [0], tmp_path / "bad", hyper_variants=[{"tau": 0.5}, {"tau": 300}])
    # distributed.devices shards the group's units over ranks (ported): two
    # units over two spawned CPU ranks, each writing its unit; a unit count
    # that does not divide raises
    spawned = []
    spawn = mesh.spawn
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh, "spawn", lambda fn, world, *a, **k: spawned.append(world) or spawn(fn, world, *a, **k))
        dist_cfg = load_config(MATRIX + ["device=cpu", "distributed.devices=2", "algorithm.total_steps=200"])
        dirs = port_sweep.run_vmapped_multiseed(dist_cfg, [0, 1], tmp_path / "dist")
    assert spawned == [2] and [d.name for d in dirs] == ["seed_0", "seed_1"]
    assert all(len(_rows(d / "results.csv")) >= 1 for d in dirs)
    with pytest.raises(ValueError, match="divide"):
        port_sweep.run_vmapped_multiseed(load_config(MATRIX + ["device=cpu", "distributed.devices=2"]), [0],
                                         tmp_path / "dist1")
    _, state, _, _ = port_sweep.build_group(cfg, [0, 1])
    with pytest.raises(NotImplementedError, match="does not checkpoint"):
        state.state_dict()
    assert not list(tmp_path.glob("bad/**/results.csv"))
