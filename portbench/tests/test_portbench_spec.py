"""The benchmark's files: every cell and configuration loads, the layout
is found by name, and BENCHMARK.json keeps its fixed keys and limits."""

import json
import re
import shutil

import pytest

from portbench import families, run, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"env_steps_per_s", "peak_mem_gib", "setup_s"} <= e2e
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["name"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"] == f"portbench/configs/{c['name']}.json"
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(cell):
    w = spec.workload(cell)
    entry = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert w["config"] == entry["config"] and w["chips"] == entry["chips"] and w["why"] == entry["why"]
    c = spec.config(w["config"])
    family = families.load(c["family"])
    assert set(family.TRAFFIC) <= set(w["traffic"])
    assert c["reduced"] == next(x for x in BENCH["configs"] if x["name"] == w["config"])["reduced"]
    assert set(c["limits"]) == set(family.LIMITS)


@pytest.mark.parametrize("config", sorted(p.stem for p in (spec.ROOT / "configs").glob("*.json")))
def test_config_states_the_composed_preset(config):
    """The published widths and the reference's constants in each
    configuration file are what the port's config composes."""
    from codebase_tpu_torch.config import load_config

    from portbench.tests.tiny import tiny_traffic

    c = spec.config(config)
    cfg = load_config(run.compose({"traffic": tiny_traffic(config)}, c, 0, "cpu"))
    a = cfg.algorithm
    m, ref = c["model"], c["reference"]
    assert int(cfg.env.time_limit) == c["time_limit"] and cfg.env.name == c["env"]
    assert a.optimizer == m["optimizer"] and a.target_update_interval_or_tau == m["target_update_interval_or_tau"]
    assert (a.lr, a.gamma) == (m["lr"], m["gamma"]) == (ref["lr"], ref["gamma"])
    if c["family"] == "dqn":
        assert list(a.model.layers) == m["layers"] and bool(a.model.use_rnn) == m["use_rnn"]
        assert a.model.parameter_sharing == m["parameter_sharing"] and a.double_q == m["double_q"]
        assert a.grad_clip == m["grad_clip"] == ref["grad_clip"]
        return
    assert c["family"] == "ac"
    for net in ("actor", "critic"):
        for key, value in m[net].items():
            assert a.model[net][key] == value, (net, key)
    assert a.model.name == m["name"] and (a.model.name == "ppo") == ref["ppo"]
    assert bool(a.model.critic.centralised) == ref["centralised_critic"]
    for key in ("grad_clip", "n_steps", "entropy_coef", "value_loss_coef", "use_proper_termination",
                "standardise_returns", "num_epochs", "ppo_clip"):
        assert a.get(key) == m[key], key
    for key in ("n_steps", "entropy_coef", "value_loss_coef", "num_epochs", "ppo_clip"):
        assert m[key] == ref[key], key
    # what the reference follows: no clip, no return or reward standardisation
    assert not a.grad_clip and not a.standardise_returns and not cfg.env.get("standardise_rewards", False)
    assert not a.model.actor.parameter_sharing and not a.model.critic.parameter_sharing


@pytest.mark.parametrize("trace", [0, 1])
def test_every_metric_file_loads(trace):
    for name in spec.run_metrics(BENCH, bool(trace)):
        mod = spec.metric(name)
        entry = next(m for m in BENCH["end_to_end"] + BENCH["per_layer"] if m["name"] == name)
        assert (mod.UNIT, mod.SOURCE) == (entry["unit"], entry["source"])
        if trace:
            assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])


def test_new_cell_and_metric_are_found_by_name(tmp_path):
    """A cell and a metric added as new files, in a copy, are found by their
    names without an edit to any file that was there."""
    root = tmp_path / "portbench"
    shutil.copytree(spec.ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((spec.ROOT.parent / "BENCHMARK.json").read_text())
    w = dict(spec.workload("idqn_rnn_lbf.collect"), name="idqn_rnn_lbf.dummy")
    (root / "workloads" / "idqn_rnn_lbf.dummy.json").write_text(json.dumps(w))
    (root / "metrics" / "dummy_ms.py").write_text(
        'NAME = "dummy_ms"\nUNIT = "ms"\nLAYER = "kernels"\nMOVES = "env_steps_per_s"\n'
        'SOURCE = "device_trace"\n\n\ndef read(ctx):\n    return 1.5 if ctx.get("trace") else None\n')
    bench["workloads"].append({"name": w["name"], "config": w["config"], "traffic": "dummy", "chips": 1,
                               "why": w["why"]})
    bench["per_layer"].append({"name": "dummy_ms", "unit": "ms", "better": "lower", "source": "device_trace",
                               "layer": "kernels", "moves": "env_steps_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.workload("idqn_rnn_lbf.dummy", root)["traffic"] == w["traffic"]
    assert "dummy_ms" in spec.run_metrics(spec.benchmark(root), True)
    assert "dummy_ms" not in spec.run_metrics(spec.benchmark(root), False)
    dummy = spec.metric("dummy_ms", root)
    assert dummy.read({"trace": {}}) is None and dummy.read({"trace": {"iters": 3}}) == 1.5  # nothing to read: left out
