"""The recurrent learning gates (`gate.RNN_GATES`: `idqn_rnn_lbf`, the main
path, and `mappo_rnn_lbf`) and the JAX curves they are held against.

No JAX runner ran a recurrent model, so the JAX curves were made on the CPU
with the unchanged JAX package: `PYTHONPATH=. python
tests/test_torch_gate_rnn.py` runs each JAX seed of both gates as one
`JAX_PLATFORMS=cpu python -m codebase_tpu.run +algorithm=<algo> <the gate's
overrides> seed=<s> run_dir=...` (in `outputs/jax_cpu_rnn/`, 10 at once by
default; about an hour on 8 cores) and vendors each results.csv flat to
`docs/gate_evidence/fw_cpu_rnn/<gate>/<algo>_seed<s>.csv`, seed 0's
`config.yaml`, and a `provenance.json` with each command, the commit, the
jax/jaxlib versions, each seed's wall seconds and the CPU. On the CPU the
JAX GRU takes its plain path, the function the port's kernels compute.
"""

import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import yaml  # noqa: E402

from codebase_tpu_torch import card_vs_cpu, gate  # noqa: E402
from codebase_tpu_torch.config import load_config as port_load_config  # noqa: E402
from codebase_tpu_torch.envs.factory import make_env  # noqa: E402

torch.set_num_threads(2)
EVIDENCE = REPO / "docs" / "gate_evidence"
RNN = sorted(gate.RNN_GATES)
# the port's own top-level key, not in the JAX package's config, and a key
# whose value is the port's own
PORT_ONLY, PORT_VALUE = {"device"}, {"project_name"}


def _jax_argv(name, seed):
    g = gate.GATES[name]
    return [f"+algorithm={g.algo}", *g.overrides, f"seed={seed}", f"run_dir={name}/{g.algo}_seed{seed}"]


def _cpu() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def make_jax_curves(names=tuple(gate.RNN_GATES), work=REPO / "outputs" / "jax_cpu_rnn", procs=10) -> dict:
    """Run every JAX seed of the gates `names` on the CPU, `procs` at once,
    then vendor the curves, each gate's config.yaml and its provenance."""
    import jax
    import jaxlib

    work = Path(work)
    work.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}
    jobs = [(name, s) for name in names for _, seeds in gate.GATES[name].jax_dirs for s in seeds]
    running, walls, rcs = [], {}, {}
    while jobs or running:
        while jobs and len(running) < procs:
            name, s = jobs.pop(0)
            log = open(work / f"{name}_seed{s}.log", "w")
            cmd = [sys.executable, "-m", "codebase_tpu.run", *_jax_argv(name, s)]
            running.append((name, s, subprocess.Popen(cmd, env=env, cwd=work, stdout=log,
                                                      stderr=subprocess.STDOUT), time.monotonic(), log))
        for job in list(running):
            name, s, proc, t0, log = job
            if proc.poll() is None:
                continue
            running.remove(job)
            log.close()
            walls[(name, s)], rcs[(name, s)] = time.monotonic() - t0, proc.returncode
        time.sleep(5.0)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True, text=True).stdout.strip()
    unchanged = subprocess.run(["git", "diff", "--quiet", "HEAD", "--", "codebase_tpu"], cwd=REPO).returncode == 0
    out = {}
    for name in names:
        g = gate.GATES[name]
        (dest,) = {EVIDENCE / sub for sub, _ in g.jax_dirs}
        dest.mkdir(parents=True, exist_ok=True)
        seeds = [s for _, ss in g.jax_dirs for s in ss]
        for s in seeds:
            if rcs[(name, s)] != 0:
                raise RuntimeError(f"{name} seed {s}: rc {rcs[(name, s)]}, see {work / f'{name}_seed{s}.log'}")
            run_dir = work / name / f"{g.algo}_seed{s}"
            (dest / f"{g.algo}_seed{s}.csv").write_bytes((run_dir / "results.csv").read_bytes())
        (dest / "config.yaml").write_bytes((work / name / f"{g.algo}_seed0" / "config.yaml").read_bytes())
        prov = {
            "gate": name,
            "commands": {str(s): "JAX_PLATFORMS=cpu PYTHONPATH=. python -m codebase_tpu.run "
                         + " ".join(_jax_argv(name, s)) for s in seeds},
            "commit": commit, "codebase_tpu_unchanged_from_commit": unchanged,
            "jax": jax.__version__, "jaxlib": jaxlib.__version__, "python": platform.python_version(),
            "wall_s_by_seed": {str(s): round(walls[(name, s)], 1) for s in seeds},
            "cpu": _cpu(), "cpu_count": os.cpu_count(), "runs_at_once": procs,
            "last_step_by_seed": {str(s): gate._read_csv(dest / f"{g.algo}_seed{s}.csv")[-1][0] for s in seeds},
        }
        (dest / "provenance.json").write_text(json.dumps(prov, indent=1) + "\n")
        out[name] = prov
    return out


# --- the JAX curves and the gates' configs


def _jax_dir(name):
    (sub,) = {sub for sub, _ in gate.GATES[name].jax_dirs}
    return EVIDENCE / sub


@pytest.mark.parametrize("name", RNN)
def test_jax_curves_are_vendored_with_their_provenance(name):
    """5 JAX seeds a gate, each run to the 1,000,000-step budget, made by
    the commands of `provenance.json`: the unchanged JAX run CLI on the CPU
    with the gate's overrides letter for letter. A run ends once its steps
    pass the budget, and logs a row once 20,000 steps passed since the last
    (two chunks of 80 iterations where episodes end early), so its last row
    lies within two cadences of the budget, as in the JAX package's own
    vendored curves (`fw_r4/ippo_seed0.csv` ends at 1,990,860 of 2M)."""
    g, d = gate.GATES[name], _jax_dir(name)
    curves = gate.jax_curves(g)
    assert sorted(curves) == [0, 1, 2, 3, 4] and g.jax_dirs == ((f"{gate.RNN_CPU}/{name}", (0, 1, 2, 3, 4)),)
    budget, cadence = gate.total_steps(g.overrides), int(gate._last(g.overrides, "algorithm.log_interval"))
    assert budget == 1_000_000 and all(c[-1][0] > budget - 2 * cadence for c in curves.values())
    prov = json.loads((d / "provenance.json").read_text())
    assert prov["gate"] == name and prov["codebase_tpu_unchanged_from_commit"]
    assert all(len(prov["commit"]) == 40 and prov[k] for k in ("jax", "jaxlib", "cpu", "wall_s_by_seed"))
    for s in range(5):
        cmd = prov["commands"][str(s)]
        assert cmd == "JAX_PLATFORMS=cpu PYTHONPATH=. python -m codebase_tpu.run " + " ".join(_jax_argv(name, s))
        assert prov["last_step_by_seed"][str(s)] == curves[s][-1][0]
    # the gate cites its recipe
    assert g.groups == ((f"docs/gate_evidence/{gate.RNN_CPU}/{name}/provenance.json", tuple(g.overrides)),)
    assert g.runs == (g.groups[0][0],)


@pytest.mark.parametrize("name", RNN)
def test_gate_overrides_give_the_vendored_jax_config(name):
    """The gate's overrides give, key for key, the JAX run's config.yaml
    through the JAX package's `load_config` and through the port's; only
    the port's own keys differ (the port's defaults lacked the JAX
    package's `resume: null` before this test)."""
    from codebase_tpu.config import load_config as jax_load_config

    vendored = yaml.safe_load((_jax_dir(name) / "config.yaml").read_text())
    argv = [f"+algorithm={gate.GATES[name].algo}", *gate.GATES[name].overrides, "seed=0",
            f"run_dir={name}/{gate.GATES[name].algo}_seed0"]
    assert yaml.safe_load(jax_load_config(argv).to_yaml()) == vendored
    port = port_load_config(argv).to_dict()
    assert set(port) - set(vendored) == PORT_ONLY and set(vendored) <= set(port)
    assert port["project_name"] == "codebase_tpu_torch" != vendored["project_name"]
    assert ({k: v for k, v in port.items() if k not in PORT_ONLY | PORT_VALUE}
            == {k: v for k, v in vendored.items() if k not in PORT_VALUE})
    # recurrent: the main path's GRU(128), MAPPO's actor and critic
    model = vendored["algorithm"]["model"]
    nets = [model] if gate.GATES[name].algo == "idqn" else [model["actor"], model["critic"]]
    assert all(n["use_rnn"] is True and n["layers"] == [128, 128] for n in nets)


def test_vendored_rnn_verdicts_rederive_from_the_vendored_curves():
    """The card's curves of both gates: at least 5 seeds run to the
    1,000,000-step budget (10 for mappo_rnn_lbf), every vendored curve
    done, and the strict verdict in PORT_GATE_h100.json re-derived from the
    vendored curves, as `gate.py compare` gives it, at a step within two
    cadences of the budget (the JAX curves' last rows)."""
    record = json.loads((EVIDENCE / "PORT_GATE_h100.json").read_text())["gates"]
    for name, least in (("idqn_rnn_lbf", 5), ("mappo_rnn_lbf", 10)):
        entry, g = record[name], gate.GATES[name]
        port = gate.port_curves(EVIDENCE / "port_h100", name)
        assert sorted(port) == entry["fw_seeds"] == entry["seeds_done"] and len(port) >= least, name
        assert set(g.seeds) <= set(entry["seeds_done"]) and not entry["partial"], name
        assert "H100" in entry["card"] and entry["compared_at_step"] > 1_000_000 - 2 * 20_000, name
        # a JAX curve's last row lies below the budget: no comparison at it
        assert min(c[-1][0] for c in gate.jax_curves(g).values()) < 1_000_000, name
        assert "at_jax_budget" not in entry and gate.judge_at_budget(name, EVIDENCE / "port_h100") is None, name
        again = gate.compare(g.algo, gate.jax_curves(g), port, gate.TAIL, 0.0)
        assert {k: entry[k] for k in again} == again, name
        assert gate.judge(name, EVIDENCE / "port_h100") == {k: v for k, v in entry.items() if k in gate.judge(
            name, EVIDENCE / "port_h100")}, name


# --- card against CPU, here cpu against cpu at a small size


def test_idqn_rnn_updates_cpu_against_cpu():
    out = card_vs_cpu.idqn_rnn_updates("cpu", n_updates=3, batch_size=4)
    assert out["config"] == "idqn_rnn_lbf" and out["T"] == 25 and out["batch_size"] == 4
    assert out["max_rel"] == {"loss": 0.0} and len(out["max_rel_by_update"]) == 3
    assert out["params_max_abs"] == {"after_update_1": 0.0, "after_update_3": 0.0}
    assert out["tolerance"] == card_vs_cpu.RNN_UPDATE_TOL and out["gru_launches"] == {}  # plain on the CPU


def test_mappo_rnn_updates_cpu_against_cpu():
    out = card_vs_cpu.mappo_rnn_updates("cpu", n_updates=3, T=10, envs=2)
    assert out["config"] == "mappo_rnn_lbf" and (out["envs"], out["T"], out["n_steps"]) == (2, 10, 5)
    assert set(out["max_rel"]) == set(card_vs_cpu.METRICS) and not any(out["max_rel"].values())
    assert not any(out["params_max_abs"].values())


def test_update_check_names_the_first_difference():
    """A difference beyond the tolerance raises at its update, naming the
    metric; params beyond it name their leaves."""
    tol = card_vs_cpu.RNN_UPDATE_TOL
    same = [torch.ones(3)]

    def step(u):
        return {"loss": torch.tensor(1.0 + (2e-3 if u == 1 else 0.0))}, {"loss": torch.tensor(1.0)}

    with pytest.raises(AssertionError, match=r"update 2: \['loss'\]"):
        card_vs_cpu._check_updates("x", 3, tol, ("loss",), step, lambda: (same, same))
    ok = card_vs_cpu._check_updates("x", 2, tol, ("loss",), lambda u: ({"loss": torch.tensor(1.0)},) * 2,
                                    lambda: (same, same))
    assert ok["max_rel"] == {"loss": 0.0}
    with pytest.raises(AssertionError, match=r"params after update 1: leaves \[1\]"):
        card_vs_cpu._check_updates("x", 2, tol, ("loss",), lambda u: ({"loss": torch.tensor(1.0)},) * 2,
                                   lambda: ([torch.ones(3), torch.ones(3) + 1e-3], [torch.ones(3)] * 2))


@pytest.mark.parametrize("name", RNN)
def test_update_checks_reach_the_gru(name):
    """The checked configs' networks are GRU(128) layers on the resident
    kernels' route (on a CPU tensor the kernel's wrapper takes its plain
    version), at the gate's 10 envs and 2 agents."""
    from codebase_tpu_torch.algos import ac, dqn

    cfg, acfg, env = card_vs_cpu._gate_config(name)
    assert int(acfg.parallel_envs) == 10 and env.n_agents == 2
    gens = [torch.Generator().manual_seed(0)]
    if gate.GATES[name].algo == "idqn":
        nets = [dqn.DQNModel.create(env, acfg.model, acfg, generator=gens).critic]
    else:
        model = ac.ACModel.create(env, acfg.model, acfg, generator=gens)
        nets = [model.actor, model.critic]
    assert [(n.spec.cell, n.spec.dims[1:3], n.spec.route) for n in nets] == [
        ("gru", (128, 128), "kernel_resident")] * len(nets)


def test_lbf_rollout_has_lbfs_shapes_and_ranges():
    env = make_env("Foraging-8x8-2p-3f-v3", time_limit=25)
    r = card_vs_cpu.lbf_rollout(np.random.default_rng(0), env, 25, 64)
    assert r["obs"].shape == (26, 64, 2, env.obs_dim) and r["actions"].shape == (25, 64, 2)
    triples = r["obs"].reshape(26, 64, 2, -1, 3)
    assert triples[..., :2].min() == -1 and triples[..., :2].max() == 7 and set(np.unique(triples[..., 2])) <= {0, 1, 2, 3}
    lengths = r["filled"].sum(0)
    assert (r["dones"].sum(0) == 1).all() and (r["dones"][lengths.astype(int), np.arange(64)] == 1).all()
    assert ((r["rewards"].sum(-1) > 0) <= (r["filled"] > 0)).all() and 5 <= lengths.min() and lengths.max() == 25
    # the real env's observations lie in the same ranges
    _, ts = env.reset_batch(torch.Generator().manual_seed(0), 64)
    assert ts.obs.min() >= -1 and ts.obs.max() <= 7


if __name__ == "__main__":
    print(json.dumps(make_jax_curves(), indent=1))
    sys.exit(0)
