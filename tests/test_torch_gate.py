"""The port's learning gate (`codebase_tpu_torch/gate.py`) against the JAX
package's gate apparatus: its comparison equals `compare_gate.py`'s on every
vendored JAX pair, its gate matrix is the JAX runners' letter for letter,
its runner's cut-and-resumed runs write an uncut run's rows, and the
vendored card verdicts re-derive from the vendored curves."""

import ast
import json
import math
import re
import shutil
import sys
from pathlib import Path

import pytest

from codebase_tpu_torch import eval as port_eval
from codebase_tpu_torch import gate

REPO = Path(__file__).resolve().parents[1]
EVIDENCE = REPO / "docs" / "gate_evidence"
sys.path.insert(0, str(REPO / "scripts" / "ref_gate"))
import compare_gate  # noqa: E402

# every vendored pair of the JAX package's gates: (reference dir, JAX dir, algo)
PAIRS = [("ref", "fw", a) for a in ("idqn", "ia2c")] + [("ref_r3", "fw_r3", "idqn")] + [
    ("ref_r4", "fw_r4", a) for a in ("idqn", "ia2c", "ippo", "maa2c", "mappo", "qmix", "vdn")] + [
    ("ref_r5/lbf", "fw_r5/lbf", a) for a in ("ippo", "maa2c")] + [
    ("ref_r5/rware", "fw_r5/rware", "ia2c")] + [("ref_r5/smaclite3m", "fw_r5/smaclite3m", a) for a in ("qmix", "vdn")]

# a tiny config for the runner: the ippo gate cut to a 5x5 grid, T=5, on the CPU
TINY = ["env.name=Foraging-5x5-2p-1f-v3", "env.time_limit=5", "algorithm.total_steps=6000",
        "algorithm.eval_interval=1000", "algorithm.log_interval=1000", "device=cpu"]


def _load(module, sub, algo):
    return {int(p.stem.split("seed")[1]): module._read_csv(p)
            for p in sorted((EVIDENCE / sub).glob(f"{algo}_seed*.csv"))}


@pytest.mark.parametrize("ref_dir,fw_dir,algo", PAIRS, ids=[f"{f}-{a}" for _, f, a in PAIRS])
def test_compare_equals_compare_gate_on_every_vendored_pair(ref_dir, fw_dir, algo):
    ref, fw = _load(compare_gate, ref_dir, algo), _load(compare_gate, fw_dir, algo)
    assert ref and fw
    assert _load(gate, ref_dir, algo) == ref and _load(gate, fw_dir, algo) == fw
    for tail, slack in ((5, 0.0), (3, 0.1)):
        assert gate.compare(algo, ref, fw, tail, slack) == compare_gate.compare(algo, ref, fw, tail, slack)


def _cited_text(cite):
    path, lines = cite.rsplit(":", 1)
    first, _, last = lines.partition("-")
    text = (REPO / path).read_text().splitlines()
    return "\n".join(text[int(first) - 1:int(last or first)])


# the gates the JAX runners ran (the recurrent gates' JAX curves were made
# on the CPU: tests/test_torch_gate_rnn.py)
SCRIPT_GATES = sorted(n for n in gate.GATES if n not in gate.RNN_GATES)


@pytest.mark.parametrize("name", SCRIPT_GATES)
def test_gate_overrides_are_the_jax_runners_letter_for_letter(name):
    g = gate.GATES[name]
    for cite, tokens in g.groups:
        text = _cited_text(cite)
        for tok in tokens:
            assert re.search(rf"(?<![\w.=]){re.escape(tok)}(?![\w.])", text), (name, cite, tok, text)
    # the lines that ran the JAX curves run this gate's algorithm
    for cite in g.runs:
        text = _cited_text(cite)
        assert re.search(rf"\brun\s+(\w+\s+)?{g.algo}\s+\$s\b", text), (name, cite, text)
        for var in re.findall(r"\$([A-Z]+)\b", text):  # SMAC, LBF, RWARE: this gate's overrides
            defined = re.search(rf"^{var}=\"([^\"]*)\"", (REPO / cite.split(":")[0]).read_text(), re.M).group(1)
            assert set(defined.split()) <= set(g.overrides), (name, var)
    # the JAX curves the table names are vendored, one a seed, and the port
    # trains as many seeds
    curves = gate.jax_curves(g)
    assert sorted(curves) == list(g.seeds) and all(curves.values())
    assert gate.total_steps(g.overrides) in (1_000_000, 2_000_000)
    assert gate._last(g.overrides, "algorithm.log_interval") == gate._last(g.overrides, "algorithm.eval_interval")


def test_gate_table():
    expected = {"idqn_lbf": ("idqn", 10, 2_000_000), "ippo_lbf": ("ippo", 10, 2_000_000),
                "qmix_smaclite3m": ("qmix", 5, 1_000_000), "ia2c_rware": ("ia2c", 5, 2_000_000),
                "maa2c_lbf": ("maa2c", 10, 2_000_000), "mappo_lbf": ("mappo", 5, 2_000_000),
                "ia2c_lbf": ("ia2c", 5, 2_000_000), "vdn_smaclite3m": ("vdn", 5, 1_000_000),
                "vdn_lbf": ("vdn", 5, 1_000_000), "qmix_lbf": ("qmix", 5, 1_000_000),
                "idqn_rnn_lbf": ("idqn", 5, 1_000_000), "mappo_rnn_lbf": ("mappo", 10, 1_000_000)}
    got = {n: (g.algo, len(g.seeds), gate.total_steps(g.overrides)) for n, g in gate.GATES.items()}
    assert got == expected
    assert all(gate._last(g.overrides, "algorithm.log_interval") == gate._last(g.overrides, "algorithm.eval_interval")
               for g in gate.GATES.values())  # each row a checkpoint
    assert "env.parallel_envs=1" in gate.GATES["idqn_lbf"].overrides
    assert "env.parallel_envs=1" not in gate.GATES["ippo_lbf"].overrides  # the preset's 10 envs
    assert "env.parallel_envs=10" in gate.GATES["idqn_rnn_lbf"].overrides
    assert "algorithm.model.use_rnn=true" in gate.GATES["idqn_rnn_lbf"].overrides
    assert {"algorithm.model.actor.use_rnn=true", "algorithm.model.critic.use_rnn=true"} <= set(
        gate.GATES["mappo_rnn_lbf"].overrides)


def test_gate_module_imports_no_jax_scripts_or_compare_gate():
    for path in (REPO / "codebase_tpu_torch" / "gate.py", REPO / "chip_smoke.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in names if m.split(".")[0] in ("jax", "codebase_tpu", "compare_gate", "scripts")], path


def _rows_text(root, seed, name="ippo_lbf"):
    return (root / name / f"{gate.GATES[name].algo}_seed{seed}" / "results.csv").read_text()


@pytest.mark.parametrize("name", ["ippo_lbf", "mappo_rnn_lbf"])
def test_run_cut_by_the_budget_and_resumed_writes_the_uncut_rows(tmp_path, monkeypatch, name):
    """Also for the recurrent MAPPO gate (GRU(128) actor and centralised
    critic): a resume restores the recurrent weights, their Adam moments
    and the target critic, and the rows are the uncut run's bit for bit."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the same threads in every run: bitwise rows
    uncut = gate.run([name], tmp_path / "uncut", 300, procs=2, seeds=[0, 1], extra=TINY)
    assert [st["state"] for st in uncut] == ["done", "done"]
    # the first cut half way between the uncut run's first row and its end,
    # then longer budgets until both seeds finish
    timing = uncut[0]["by_call"][0]
    budget = timing["first_row_s"] + 0.5 * (timing["wall_s"] - timing["first_row_s"])
    calls = []
    while len(calls) < 8:
        statuses = gate.run([name], tmp_path / "cut", budget, procs=2, seeds=[0, 1], extra=TINY)
        calls.append(statuses)
        if all(st["state"] in ("done", "skipped") for st in statuses):
            break
        budget *= 1.5
    states = [st["state"] for c in calls for st in c]
    assert "cut" in states and all(s in ("cut", "done", "skipped") for s in states), calls
    resumed = [st["resumed_at"] for c in calls[1:] for st in c if st["state"] != "skipped"]
    assert any(step > 0 for step in resumed), calls  # a run continued from a mid-run checkpoint
    for seed in (0, 1):
        rows = _rows_text(tmp_path / "cut", seed, name)
        assert rows == _rows_text(tmp_path / "uncut", seed, name)
        steps = [int(line.split(",")[0]) for line in rows.splitlines()[1:]]
        assert steps == list(range(1000, 7001, 1000))  # the JAX package's rows: no duplicate, no gap
        run_dir = tmp_path / "cut" / name / f"{gate.GATES[name].algo}_seed{seed}"
        status = json.loads((run_dir / "gate_status.json").read_text())
        assert status["state"] == "done" and status["calls"] == len(status["by_call"]) >= 1
    # a finished seed is skipped
    again = gate.run([name], tmp_path / "cut", 60, procs=2, seeds=[0, 1], extra=TINY)
    assert [st["state"] for st in again] == ["skipped", "skipped"]


def test_prepare_resume_keeps_the_newest_checkpoint_on_a_row(tmp_path):
    run_dir = tmp_path / "run"
    (run_dir / "checkpoints").mkdir(parents=True)
    (run_dir / "results.csv").write_text("environment_steps,x\n100,1\n200,2\n300,3\n")
    for step in (100, 200, 260):  # 260: a preemption's, between rows
        (run_dir / "checkpoints" / f"model_s{step}.msgpack").write_bytes(b"")
    (run_dir / "checkpoints" / "model_s300.msgpack.tmp").write_bytes(b"")
    assert gate.prepare_resume(run_dir) == 200
    assert sorted(p.name for p in (run_dir / "checkpoints").iterdir()) == ["model_s100.msgpack", "model_s200.msgpack"]
    assert (run_dir / "results.csv").read_text() == "environment_steps,x\n100,1\n200,2\n"
    shutil.rmtree(run_dir / "checkpoints")
    assert gate.prepare_resume(run_dir) == 0 and not (run_dir / "results.csv").exists()


def test_run_trains_seeds_beyond_the_gates_own_list(tmp_path, monkeypatch):
    """`--seeds` may name seeds the gate's list lacks (ia2c_rware's is 0-4):
    each trains as a further independent sample, and `port_curves` reads it."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    tiny = ["env.time_limit=5", "env.parallel_envs=4", "algorithm.total_steps=2000",
            "algorithm.eval_interval=1000", "algorithm.log_interval=1000", "device=cpu"]
    statuses = gate.run(["ia2c_rware"], tmp_path, 120, seeds=[7], extra=tiny)
    assert [(st["seed"], st["state"]) for st in statuses] == [(7, "done")]
    assert sorted(gate.port_curves(tmp_path, "ia2c_rware")) == [7]
    assert "seed=7" in (tmp_path / "ia2c_rware" / "ia2c_seed7" / "config.yaml").read_text().replace(": ", "=")


def test_run_refuses_the_runners_own_keys_and_unequal_cadences(tmp_path):
    with pytest.raises(ValueError, match="sets"):
        gate.run(["ippo_lbf"], tmp_path, 1, extra=["seed=3"])
    with pytest.raises(ValueError, match="must be equal"):
        gate.run(["ippo_lbf"], tmp_path, 1, extra=["algorithm.log_interval=500"])


def test_ckpt_scores_each_seed_with_the_eval_cli(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    tiny = ["env.name=Foraging-5x5-2p-1f-v3", "env.time_limit=5", "algorithm.total_steps=200",
            "algorithm.eval_interval=100", "algorithm.log_interval=100", "algorithm.training_start=0",
            "algorithm.batch_size=2", "algorithm.buffer_size=16", "env.parallel_envs=4", "device=cpu"]
    statuses = gate.run(["idqn_lbf"], tmp_path, 120, procs=2, seeds=[0, 1], extra=tiny)
    assert [st["state"] for st in statuses] == ["done", "done"]
    result = gate.ckpt("idqn_lbf", tmp_path, episodes=20, extra=["device=cpu"])
    assert sorted(result["port_values"]) == ["0", "1"]
    direct = port_eval.main([f"path={tmp_path / 'idqn_lbf' / 'idqn_seed1'}", "eval_episodes=20", "seed=0",
                             "device=cpu"]).sum(-1).mean()
    assert result["port_values"]["1"] == round(float(direct), 4)
    jax = json.loads((EVIDENCE / "CKPT_GATE_r4.json").read_text())
    assert result["jax_values"] == jax["fw_values"] and result["jax_mean"] == jax["fw_mean"]
    assert result["strict_pass"] == (abs(result["port_mean"] - result["jax_mean"]) <= result["strict_band"])


def test_vendored_card_verdicts_rederive_from_the_vendored_curves():
    record = json.loads((EVIDENCE / "PORT_GATE_h100.json").read_text())
    assert {"ippo_lbf", "qmix_smaclite3m", "idqn_lbf", "ia2c_rware"} <= set(record["gates"])
    for name, entry in record["gates"].items():
        g = gate.GATES[name]
        # partial: a seed of the gate's own list not done (seeds beyond it
        # are further samples)
        assert entry["partial"] == (not set(g.seeds) <= set(entry["seeds_done"])), name
        assert "H100" in entry["card"], name
        port = gate.port_curves(EVIDENCE / "port_h100", name)
        if "compared_at_step" not in entry:  # no step with a row on every curve yet
            assert gate.judge(name, EVIDENCE / "port_h100") is None, name
            continue
        assert sorted(port) == entry["fw_seeds"], name
        again = gate.compare(g.algo, gate.jax_curves(g), port, gate.TAIL, 0.0)
        assert {k: entry[k] for k in again} == again, name
        assert entry["jax_budget"] == gate.total_steps(g.overrides)
        if "at_jax_budget" in entry:  # every curve ran past the budget: compared there too
            budget = entry["jax_budget"]
            cut = [{s: [r for r in c if r[0] <= budget] for s, c in side.items()}
                   for side in (gate.jax_curves(g), port)]
            again = gate.compare(g.algo, *cut, gate.TAIL, 0.0)
            assert again["compared_at_step"] == budget < entry["compared_at_step"], name
            assert {k: entry["at_jax_budget"][k] for k in again} == again, name
            assert gate.judge(name, EVIDENCE / "port_h100", at_step=budget) == entry["at_jax_budget"], name
    # ia2c_rware with 10 port seeds (5-9 beyond the gate's own list), done,
    # compared at the largest common step and at the JAX budget
    rware = record["gates"]["ia2c_rware"]
    assert rware["fw_seeds"] == rware["seeds_done"] == list(range(10)) and not rware["partial"]
    assert rware["compared_at_step"] == 2_020_000 and rware["at_jax_budget"]["fw_seeds"] == list(range(10))


def test_ia2c_rware_strict_fail_and_its_rows_with_a_delivery():
    """The card's ia2c_rware gate failed the strict rule with the port's
    first 5 seeds at 2,020,000 steps (their tail-5 mean above the JAX
    curves', by more than 2 JAX stds) and passes with 10, at 2,020,000 and
    at the JAX budget. A row holds 10 training episodes, so a return of
    0.02 is one delivery: over each million steps the rows with a delivery
    a seed of the two sides agree within two standard deviations of their
    Poisson difference, for the first 5 port seeds and for all 10."""
    entry = json.loads((EVIDENCE / "PORT_GATE_h100.json").read_text())["gates"]["ia2c_rware"]
    assert entry["compared_at_step"] == 2_020_000 and not entry["partial"]
    jax, port = gate.jax_curves(gate.GATES["ia2c_rware"]), gate.port_curves(EVIDENCE / "port_h100", "ia2c_rware")
    first5 = {s: port[s] for s in range(5)}
    five = gate.compare("ia2c", jax, first5, gate.TAIL, 0.0)
    assert five["compared_at_step"] == 2_020_000
    assert not five["within_seed_variance"] and five["fw_mean"] > five["ref_mean"]
    assert entry["within_seed_variance"] and entry["at_jax_budget"]["within_seed_variance"]
    for side in (first5, port):
        for lo, hi in ((0, 1_000_000), (1_000_000, 2_020_000)):
            jax_rows, port_rows = (sum(1 for c in x.values() for s, r in c if lo < s <= hi and r > 0)
                                   for x in (jax, side))
            nj, np_ = len(jax), len(side)
            assert abs(port_rows / np_ - jax_rows / nj) <= 2 * math.sqrt(port_rows / np_**2 + jax_rows / nj**2), (
                lo, hi, np_, jax_rows, port_rows)
