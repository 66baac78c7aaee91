"""The learning gate of the port: train the JAX package's gate configurations
with the port and hold the curves against the JAX package's vendored ones.

    python -m codebase_tpu_torch.gate run <gate>... --out DIR --budget-s S [--procs N] [--seeds 0,1] [--set k=v ...]
    python -m codebase_tpu_torch.gate compare <gate>... --out DIR [--vendor EVIDENCE_DIR]
    python -m codebase_tpu_torch.gate ckpt idqn_lbf --out DIR [--episodes 2000] [--set device=cpu]

The counterpart of the JAX package's gate runners
(`scripts/ref_gate/run_fw_gate_r4.sh`, `run_fw_gate_r5.sh`), its comparison
(`scripts/ref_gate/compare_gate.py`) and its checkpoint gate
(`scripts/ref_gate/ckpt_gate.py`). Nothing here imports those scripts or the
JAX package: the comparison below is this module's own copy of
`compare_gate.py`'s stdlib logic.

`GATES` is the JAX package's gate matrix: each gate's overrides are the JAX
runner's, letter for letter, each group beside the script line it comes
from. The port's seeds cannot reproduce the JAX package's draws (threefry
against Philox), so each port seed is an independent sample.

`run` launches one `python -m codebase_tpu_torch.run` per seed, up to
`--procs` at once (they share the one GPU), each in
`DIR/<gate>/<algo>_seed<s>` with `resume=auto` and a checkpoint at every
results.csv row (`algorithm.save_interval` = the row cadence, which
replaces the JAX runner's own `save_interval`; checkpoints change no
training semantics). At `--budget-s` seconds it sends SIGTERM: the port's
preemption guard checkpoints after the chunk in flight and exits, and the
next `run` resumes. A resume starts from the newest checkpoint taken at a
row (newer checkpoints are removed and the rows after it dropped), so the
cadences continue as in an uncut run and no row is duplicated or missing.
An actor-critic run's rows are then those of an uncut run (bitwise on the
CPU); a value-based run's eval draws restart from `seed + 1` at a resume,
as the JAX package's eval key restarts from the seed. A seed whose run
finished (a checkpoint past `algorithm.total_steps`) is skipped. Runs go to
the GPU unless the overrides say `device=cpu`.

`compare` applies the JAX package's rule to each gate: the final return of a
curve is the mean of its last 5 rows at or below the largest step every
curve reached, and the gate passes when |port mean - JAX mean| <= 2 * JAX
std, with no slack. The JAX curves take `compare_gate.py`'s `ref` side and
the port's runs its `fw` side. It prints compare_gate's markdown table and
one JSON line a gate; `--vendor` copies each run's results.csv flat to
`EVIDENCE_DIR/<gate>/<algo>_seed<s>.csv` and records the verdicts in
`EVIDENCE_DIR/../PORT_GATE_h100.json`.

`ckpt` scores each seed's final checkpoint with the port's eval CLI
(`codebase_tpu_torch.eval`, 2000 episodes at `eps_evaluation`, eval seed 0)
and holds the scores against the JAX package's checkpoint values
(`docs/gate_evidence/CKPT_GATE_r4.json` `fw_values`) under the same rule.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
EVIDENCE = REPO / "docs" / "gate_evidence"
R4 = "scripts/ref_gate/run_fw_gate_r4.sh"
R5 = "scripts/ref_gate/run_fw_gate_r5.sh"
TAIL = 5  # rows averaged for a curve's final return

# the JAX runners' shared settings, each with the lines it comes from
LBF_BASE = (
    (f"{R4}:32-34", ("env.name=Foraging-8x8-2p-3f-v3", "env.time_limit=25", "algorithm.total_steps=2000000",
                     "algorithm.eval_interval=20000", "algorithm.log_interval=20000")),
)
EVAL_LOG_R5 = (f"{R5}:35", ("algorithm.eval_interval=20000", "algorithm.log_interval=20000"))
SMAC = (f"{R5}:62", ("env.name=smaclite:3m-v0", "env.time_limit=60", "env.parallel_envs=1",
                     "algorithm.total_steps=1000000"))
RWARE = (f"{R5}:64", ("env.name=rware-tiny-2ag-v2", "env.time_limit=500", "algorithm.total_steps=2000000"))


@dataclasses.dataclass(frozen=True)
class Gate:
    algo: str
    groups: tuple  # ((the JAX script line, (override, ...)), ...) in the JAX runner's order
    seeds: tuple
    jax_dirs: tuple  # ((dir under docs/gate_evidence, (seed, ...)), ...): the JAX curves
    runs: tuple  # the JAX script lines that ran the gate's JAX curves

    @property
    def overrides(self) -> list:
        return [tok for _, toks in self.groups for tok in toks]


def _seeds(a, b):
    return tuple(range(a, b))


GATES = {
    "idqn_lbf": Gate("idqn", LBF_BASE + ((f"{R4}:66", ("env.parallel_envs=1", "algorithm.save_interval=500000")),),
                     _seeds(0, 10), (("fw_r3", _seeds(0, 5)), ("fw_r4", _seeds(5, 10))), (f"{R4}:66",)),
    "ippo_lbf": Gate("ippo", LBF_BASE, _seeds(0, 10), (("fw_r4", _seeds(0, 5)), ("fw_r5/lbf", _seeds(5, 10))),
                     (f"{R4}:69", f"{R5}:67")),
    "qmix_smaclite3m": Gate("qmix", (EVAL_LOG_R5, SMAC), _seeds(0, 5), (("fw_r5/smaclite3m", _seeds(0, 5)),),
                            (f"{R5}:66",)),
    "ia2c_rware": Gate("ia2c", (EVAL_LOG_R5, RWARE), _seeds(0, 5), (("fw_r5/rware", _seeds(0, 5)),), (f"{R5}:69",)),
    "maa2c_lbf": Gate("maa2c", LBF_BASE, _seeds(0, 10), (("fw_r4", _seeds(0, 5)), ("fw_r5/lbf", _seeds(5, 10))),
                      (f"{R4}:68", f"{R5}:68")),
    "mappo_lbf": Gate("mappo", LBF_BASE, _seeds(0, 5), (("fw_r4", _seeds(0, 5)),), (f"{R4}:65",)),
    "ia2c_lbf": Gate("ia2c", LBF_BASE, _seeds(0, 5), (("fw", (0, 1, 2)), ("fw_r4", (3, 4))), (f"{R4}:67",)),
    "vdn_smaclite3m": Gate("vdn", (EVAL_LOG_R5, SMAC), _seeds(0, 5), (("fw_r5/smaclite3m", _seeds(0, 5)),),
                           (f"{R5}:70",)),
    "vdn_lbf": Gate("vdn", LBF_BASE + ((f"{R4}:63", ("env.parallel_envs=1", "algorithm.total_steps=1000000")),),
                    _seeds(0, 5), (("fw_r4", _seeds(0, 5)),), (f"{R4}:63",)),
    "qmix_lbf": Gate("qmix", LBF_BASE + ((f"{R4}:64", ("env.parallel_envs=1", "algorithm.total_steps=1000000")),),
                     _seeds(0, 5), (("fw_r4", _seeds(0, 5)),), (f"{R4}:64",)),
}
# the keys the runner sets itself
RUNNER_KEYS = ("seed", "run_dir", "resume", "algorithm.save_interval")


# --- the comparison: compare_gate.py's logic (`:36-104`), stdlib only


def _read_csv(path: Path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    out = []
    for r in rows:
        try:
            step = int(float(r["environment_steps"]))
            ret = float(r["mean_episode_returns"])
        except (KeyError, ValueError):
            continue
        if not math.isnan(ret):
            out.append((step, ret))
    return sorted(out)


def _final_return(curve, at_step: int, tail: int):
    eligible = [r for s, r in curve if s <= at_step]
    if not eligible:
        return None
    t = eligible[-tail:]
    return sum(t) / len(t)


def _mean_std(xs):
    m = sum(xs) / len(xs)
    var = sum((x - m) ** 2 for x in xs) / max(len(xs) - 1, 1)
    return m, math.sqrt(var)


def compare(algo: str, ref: dict, fw: dict, tail: int, abs_slack: float):
    # compare at the largest step EVERY curve reached (partial runs OK)
    at = min(c[-1][0] for c in list(ref.values()) + list(fw.values()))
    ref_f = {s: _final_return(c, at, tail) for s, c in ref.items()}
    fw_f = {s: _final_return(c, at, tail) for s, c in fw.items()}
    rm, rs = _mean_std(list(ref_f.values()))
    fm, fs = _mean_std(list(fw_f.values()))
    # strict: the framework mean must sit within 2 sigma of the REFERENCE
    # seeds (abs_slack, default 0, only widens a degenerate zero-variance band)
    ok = abs(fm - rm) <= max(2 * rs, abs_slack)
    overlap = abs(fm - rm) <= 2 * rs + 2 * fs
    return {
        "algo": algo,
        "compared_at_step": at,
        "ref_seeds": sorted(ref_f),
        "ref_final_returns": {str(s): round(v, 4) for s, v in ref_f.items()},
        "ref_mean": round(rm, 4),
        "ref_std": round(rs, 4),
        "fw_seeds": sorted(fw_f),
        "fw_final_returns": {str(s): round(v, 4) for s, v in fw_f.items()},
        "fw_mean": round(fm, 4),
        "fw_std": round(fs, 4),
        "within_seed_variance": bool(ok),
        "band_overlap": bool(overlap),
    }


# --- curves


def jax_curves(gate: Gate, evidence: Path = EVIDENCE) -> dict:
    """The JAX package's vendored curves of a gate, {seed: [(step, return)]}."""
    curves = {}
    for sub, seeds in gate.jax_dirs:
        for s in seeds:
            curves[s] = _read_csv(evidence / sub / f"{gate.algo}_seed{s}.csv")
    return curves


def _seed_of(name: str) -> int:
    return int(name.split("seed")[1].split(".")[0])


def port_curves(root: Path, name: str) -> dict:
    """The port's curves of gate `name` under `root`: run dirs
    (`<root>/<name>/<algo>_seed<s>/results.csv`, what `run` writes) or
    vendored files (`<root>/<name>/<algo>_seed<s>.csv`); empty curves left
    out, as compare_gate does."""
    gate, d = GATES[name], Path(root) / name
    paths = sorted(d.glob(f"{gate.algo}_seed*/results.csv")) + sorted(d.glob(f"{gate.algo}_seed*.csv"))
    curves = {_seed_of(p.parent.name if p.name == "results.csv" else p.name): _read_csv(p) for p in paths}
    return {s: c for s, c in curves.items() if c}


def total_steps(overrides) -> int:
    return int(_last(overrides, "algorithm.total_steps"))


def _last(overrides, key, default=None):
    vals = [tok.split("=", 1)[1] for tok in overrides if tok.split("=", 1)[0] == key]
    return vals[-1] if vals else default


def judge(name: str, root: Path, evidence: Path = EVIDENCE) -> dict | None:
    """compare_gate's verdict on gate `name` (JAX curves as ref, the port's
    as fw), with the JAX budget, or None when a side has no curve or a
    curve no row by the step every curve reached."""
    gate = GATES[name]
    ref, fw = jax_curves(gate, evidence), port_curves(root, name)
    if not ref or not fw:
        return None
    at = min(c[-1][0] for c in list(ref.values()) + list(fw.values()))
    if any(c[0][0] > at for c in list(ref.values()) + list(fw.values())):
        return None  # a curve has no row by the step every curve reached
    budget = total_steps(gate.overrides)
    return {"gate": name, **compare(gate.algo, ref, fw, TAIL, 0.0), "jax_budget": budget,
            "fw_last_steps": {str(s): c[-1][0] for s, c in sorted(fw.items())}}


def table(results) -> str:
    """compare_gate.py's markdown table."""
    lines = ["| algo | @step | reference mean±std (seeds) | framework mean±std (seeds) | within seed variance |",
             "|------|-------|---------------------------|----------------------------|----------------------|"]
    for name, s in results:
        if s is None:
            lines.append(f"| {name} | — | no common step with rows on every curve | — | INCOMPLETE |")
            continue
        lines.append(
            f"| {name} | {s['compared_at_step']} "
            f"| {s['ref_mean']:.3f}±{s['ref_std']:.3f} (n={len(s['ref_seeds'])}) "
            f"| {s['fw_mean']:.3f}±{s['fw_std']:.3f} (n={len(s['fw_seeds'])}) "
            f"| {'PASS' if s['within_seed_variance'] else 'FAIL'} |")
    return "\n".join(lines)


# --- the runner


def _rows(path: Path) -> list:
    """results.csv's data lines (text) with their steps, [(step, line)]."""
    if not path.exists():
        return []
    lines = path.read_text().splitlines()
    out = []
    for line in lines[1:]:
        try:
            out.append((int(float(line.split(",", 1)[0])), line))
        except ValueError:
            continue
    return out


def _checkpoints(run_dir: Path) -> list:
    """[(step, path)] of the run's checkpoints, oldest first."""
    found = [(int(p.stem.split("_s")[-1]), p) for p in (run_dir / "checkpoints").glob("model_s*.msgpack")]
    return sorted(found)


def is_done(run_dir: Path, budget: int) -> bool:
    """A run is done when it checkpointed past its budget: its loop runs
    until the step exceeds `total_steps` and ends with a checkpoint."""
    return any(step > budget for step, _ in _checkpoints(run_dir))


def prepare_resume(run_dir: Path) -> int:
    """Make `resume=auto` continue from the newest checkpoint taken at a
    results.csv row: remove newer checkpoints (a preemption's, between rows)
    and the rows after it. Without one, start afresh. Returns its step (0
    for a fresh start)."""
    results = run_dir / "results.csv"
    rows = _rows(results)
    row_steps = {s for s, _ in rows}
    ckpts = _checkpoints(run_dir)
    on_row = [step for step, _ in ckpts if step in row_steps]
    at = on_row[-1] if on_row else 0
    for step, path in ckpts:
        if step > at:
            path.unlink()
    for tmp in (run_dir / "checkpoints").glob("*.tmp"):
        tmp.unlink()
    if at == 0:
        results.unlink(missing_ok=True)
    elif any(s > at for s, _ in rows):
        header = results.read_text().splitlines()[0]
        results.write_text("\n".join([header] + [line for s, line in rows if s <= at]) + "\n")
    return at


def prune(run_dir: Path, keep: int = 2) -> None:
    """Remove all but the `keep` newest checkpoints (a run writes one a row)."""
    for _, path in _checkpoints(run_dir)[:-keep]:
        path.unlink(missing_ok=True)


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of GPU 0."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _status(run_dir: Path) -> dict:
    path = run_dir / "gate_status.json"
    return json.loads(path.read_text()) if path.exists() else {"wall_s": 0.0, "calls": 0}


def run(names, out, budget_s: float, procs: int = 1, seeds=None, extra=()) -> list:
    """Train the gates' seeds (`seeds`: a subset of each gate's, default
    all) as `python -m codebase_tpu_torch.run` subprocesses, up to `procs`
    at once, until they finish or `budget_s` seconds pass; then SIGTERM the
    running ones (each checkpoints and exits) and launch no more. `extra`
    overrides follow the gate's. Returns one status dict a seed:
    `state` done | cut | failed | skipped | not_started."""
    out = Path(out).resolve()
    extra = list(extra)
    bad = [tok for tok in extra if tok.split("=", 1)[0] in RUNNER_KEYS]
    if bad:
        raise ValueError(f"{bad}: the runner sets {list(RUNNER_KEYS)} itself")
    on_cpu = _last(extra, "device") == "cpu"
    jobs, statuses = [], []
    for name in names:
        gate = GATES[name]
        overrides = gate.overrides + extra
        cadence = _last(overrides, "algorithm.log_interval")
        if cadence != _last(overrides, "algorithm.eval_interval"):
            raise ValueError(f"{name}: log_interval and eval_interval must be equal (each row a checkpoint)")
        for s in (gate.seeds if seeds is None else [s for s in seeds if s in gate.seeds]):
            run_dir = out / name / f"{gate.algo}_seed{s}"
            job = {"gate": name, "seed": s, "run_dir": run_dir, "budget": total_steps(overrides),
                   "argv": [f"+algorithm={gate.algo}", *overrides, f"algorithm.save_interval={cadence}",
                            f"seed={s}", f"run_dir={run_dir}", "resume=auto"]}
            if is_done(run_dir, job["budget"]):
                statuses.append({"gate": name, "seed": s, "state": "skipped", "run_dir": str(run_dir)})
            else:
                jobs.append(job)
    if jobs and not on_cpu:
        for name in {j["gate"] for j in jobs}:
            (out / name).mkdir(parents=True, exist_ok=True)
            (out / name / "card.txt").write_text(card() + "\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))}
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // max(1, procs))))
    deadline = time.monotonic() + budget_s
    running, stopping = [], False
    try:
        while jobs or running:
            while jobs and len(running) < procs and not stopping:
                job = jobs.pop(0)
                job["run_dir"].mkdir(parents=True, exist_ok=True)
                job["resumed_at"] = prepare_resume(job["run_dir"])
                job["log"] = open(job["run_dir"].parent / f"{job['run_dir'].name}.log", "a")
                job["t0"] = time.monotonic()
                job["row_times"] = []  # (step, seconds since launch) of the rows this call writes
                job["proc"] = subprocess.Popen([sys.executable, "-m", "codebase_tpu_torch.run", *job["argv"]],
                                               env=env, cwd=out, stdout=job["log"], stderr=subprocess.STDOUT)
                running.append(job)
            if not stopping and time.monotonic() >= deadline:
                stopping = True
                for job in running:
                    job["proc"].send_signal(signal.SIGTERM)
                    job["cut"] = True
                statuses += [{"gate": j["gate"], "seed": j["seed"], "state": "not_started",
                              "run_dir": str(j["run_dir"])} for j in jobs]
                jobs = []
            for job in list(running):
                _watch_rows(job)
                if job["proc"].poll() is None:
                    prune(job["run_dir"])
                    continue
                running.remove(job)
                statuses.append(_finish(job))
            if running:
                time.sleep(1.0)
    finally:
        for job in running:  # an exception in this loop: stop every process it started
            job["proc"].kill()
            job["proc"].wait()
            job["log"].close()
    return statuses


def _watch_rows(job) -> None:
    """Note when each new results.csv row appears (to the poll's resolution)."""
    seen = job["row_times"][-1][0] if job["row_times"] else job["resumed_at"]
    t = time.monotonic() - job["t0"]
    job["row_times"] += [(s, t) for s, _ in _rows(job["run_dir"] / "results.csv") if s > seen]


def _finish(job) -> dict:
    _watch_rows(job)
    job["log"].close()
    run_dir, rc = job["run_dir"], job["proc"].returncode
    done = is_done(run_dir, job["budget"])
    prune(run_dir, keep=1 if done else 2)
    wall = time.monotonic() - job["t0"]
    status = _status(run_dir)
    status["wall_s"] += wall
    status["calls"] += 1
    state = "done" if done else ("cut" if job.get("cut") else "failed")
    rows, times = _rows(run_dir / "results.csv"), job["row_times"]
    this_call = {"wall_s": wall, "state": state, "rc": rc, "resumed_at": job["resumed_at"], "rows": len(times),
                 "first_row_s": times[0][1] if times else None,
                 # the steady rate: seconds between this call's first and last rows
                 "s_per_20000_steps": (times[-1][1] - times[0][1]) / (times[-1][0] - times[0][0]) * 20000
                 if len(times) > 1 else None}
    status.setdefault("by_call", []).append(this_call)
    status.update(state=state, rc=rc, resumed_at=job["resumed_at"], last_row_step=rows[-1][0] if rows else None,
                  budget=job["budget"])
    (run_dir / "gate_status.json").write_text(json.dumps(status, indent=1) + "\n")
    return {"gate": job["gate"], "seed": job["seed"], "run_dir": str(run_dir), **status}


# --- the checkpoint gate


def ckpt(name: str, out, episodes: int = 2000, extra=(), jax_json: Path = EVIDENCE / "CKPT_GATE_r4.json") -> dict:
    """Score each seed's final checkpoint with the port's eval CLI and hold
    the scores against the JAX package's (`fw_values` of `jax_json`):
    strict |port mean - JAX mean| <= 2 * JAX std."""
    from codebase_tpu_torch import eval as port_eval

    gate = GATES[name]
    jax_values = json.loads(Path(jax_json).read_text())["fw_values"]
    values, steps = {}, {}
    for s in gate.seeds:
        run_dir = Path(out) / name / f"{gate.algo}_seed{s}"
        found = _checkpoints(run_dir)
        if not found:
            continue
        steps[str(s)] = found[-1][0]
        returns = port_eval.main([f"path={run_dir}", f"eval_episodes={episodes}", "seed=0", *extra])
        values[str(s)] = float(returns.sum(-1).mean())
    if not values:
        raise FileNotFoundError(f"no checkpoints under {Path(out) / name}")
    pm, ps = _mean_std(list(values.values()))
    jm, js = _mean_std(jax_values)
    return {"gate": name, "episodes_per_policy": episodes, "port_values": {k: round(v, 4) for k, v in values.items()},
            "port_checkpoint_steps": steps, "jax_values": jax_values, "port_mean": round(pm, 4),
            "port_std": round(ps, 4), "jax_mean": round(jm, 4), "jax_std": round(js, 4),
            "delta": round(pm - jm, 4), "strict_band": round(2 * js, 4), "strict_pass": bool(abs(pm - jm) <= 2 * js)}


# --- vendoring


def _commit() -> str | None:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True, text=True, timeout=60)
    except OSError:
        return None
    return out.stdout.strip() or None


def vendor(names, out, evidence_dir, record) -> dict:
    """Copy each run's results.csv flat to `<evidence_dir>/<gate>/<algo>_seed<s>.csv`
    and write each gate's verdict, re-derived from the copies, into the JSON
    file `record` (other gates' entries kept), with the seeds done, each
    seed's wall seconds over all `run` calls, the card (`card.txt`), the
    checkpoint gate (`ckpt.json`) where `ckpt` wrote one, and the commit
    the port's code was checked out at."""
    out, evidence_dir, record = Path(out), Path(evidence_dir), Path(record)
    data = json.loads(record.read_text()) if record.exists() else {"gates": {}}
    for name in names:
        gate = GATES[name]
        dest = evidence_dir / name
        dest.mkdir(parents=True, exist_ok=True)
        wall, done = {}, []
        for run_dir in sorted(p for p in (out / name).glob(f"{gate.algo}_seed*") if p.is_dir()):
            if (run_dir / "results.csv").exists():
                shutil.copyfile(run_dir / "results.csv", dest / f"{run_dir.name}.csv")
            st = _status(run_dir)
            wall[str(_seed_of(run_dir.name))] = st["wall_s"]
            if st.get("state") == "done":
                done.append(_seed_of(run_dir.name))
        entry = {**(judge(name, evidence_dir) or {"gate": name}), "seeds_done": sorted(done),
                 "partial": sorted(done) != list(gate.seeds), "wall_s_by_seed": wall, "commit": _commit()}
        for key, fname in (("card", "card.txt"), ("ckpt", "ckpt.json")):
            if (out / name / fname).exists():
                text = (out / name / fname).read_text()
                entry[key] = json.loads(text) if fname.endswith(".json") else text.strip()
        data["gates"][name] = entry
    record.write_text(json.dumps(data, indent=1) + "\n")
    return data


# --- CLI


def _seed_list(text):
    return [int(s) for s in text.split(",")] if text else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m codebase_tpu_torch.gate", description=__doc__.split("\n\n")[0])
    commands = parser.add_subparsers(dest="command", required=True)
    for cmd in ("run", "compare", "ckpt"):
        sub = commands.add_parser(cmd)
        sub.add_argument("gates", nargs="+", choices=sorted(GATES))
        sub.add_argument("--out", required=True, type=Path, help="the gates' run tree: DIR/<gate>/<algo>_seed<s>")
        if cmd in ("run", "ckpt"):
            sub.add_argument("--set", dest="extra", action="append", default=[], metavar="KEY=VALUE",
                             help="an override after the gate's (device=cpu, a smaller total_steps, ...)")
    commands.choices["run"].add_argument("--budget-s", type=float, required=True,
                                         help="SIGTERM the running seeds after this many seconds")
    commands.choices["run"].add_argument("--procs", type=int, default=1, help="seeds trained at once")
    commands.choices["run"].add_argument("--seeds", type=_seed_list, default=None, help="a subset, e.g. 0,1")
    commands.choices["compare"].add_argument("--vendor", type=Path, default=None, metavar="EVIDENCE_DIR",
                                             help="copy the CSVs to EVIDENCE_DIR/<gate>/ and record the verdicts "
                                                  "in EVIDENCE_DIR/../PORT_GATE_h100.json")
    commands.choices["ckpt"].add_argument("--episodes", type=int, default=2000)
    args = parser.parse_args(argv)

    if args.command == "run":
        statuses = run(args.gates, args.out, args.budget_s, args.procs, args.seeds, args.extra)
        for st in statuses:
            print(json.dumps(st))
        return 1 if any(st["state"] == "failed" for st in statuses) else 0
    if args.command == "ckpt":
        if args.gates != ["idqn_lbf"]:
            parser.error("the checkpoint gate has JAX values for idqn_lbf only")
        result = ckpt("idqn_lbf", args.out, args.episodes, args.extra)
        (args.out / "idqn_lbf" / "ckpt.json").write_text(json.dumps(result, indent=1) + "\n")
        print(json.dumps(result))
        return 0
    results = [(name, judge(name, args.out)) for name in args.gates]
    print(table(results))
    for _, s in results:
        if s is not None:
            print(json.dumps(s))
    if args.vendor:
        vendor(args.gates, args.out, args.vendor, args.vendor.parent / "PORT_GATE_h100.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
