"""The port's Bayesian optimiser (`codebase_tpu_torch/bayes.py`) against the
JAX package's (`codebase_tpu/bayes.py`): both are numpy, so the encoder's
features, the GP posterior, expected improvement and a whole `optimise`
run on a synthetic objective agree to 1e-12; and `bayes --budget 2` of
the port's search CLI (the port reads results.csv with `csv`, not pandas)
writes the keys, candidate count and trials that the JAX CLI writes on the
same spec, whose budget stays within the random initial draws of the BO
seed."""

import json

import numpy as np
import pytest
import yaml
from click.testing import CliRunner

from codebase_tpu import bayes as jax_bayes
from codebase_tpu_torch import bayes
from codebase_tpu_torch import search

AXES = [
    {"lr": [1e-4, 1e-3, 1e-2], "alg": ["a2c", "ppo"]},
    {"gamma": [0.9, 0.95, 1.0], "batch": [8, 16, 32, 64]},
    {"x": [1, 2, 3], "flag": [True, False], "name": ["<absent>", "a", "b"]},
]


def _grid(axes):
    names = sorted(axes)
    out = [{}]
    for n in names:
        out = [{**c, n: v} for c in out for v in axes[n]]
    return out


@pytest.mark.parametrize("axes", AXES)
def test_encoder_features_match(axes):
    enc, jenc = bayes.AxisEncoder(axes), jax_bayes.AxisEncoder(axes)
    assert enc.dim == jenc.dim and enc._spec == jenc._spec
    for c in _grid(axes):
        np.testing.assert_allclose(enc.encode(c), jenc.encode(c), rtol=0, atol=1e-12)


@pytest.mark.parametrize("axes", AXES)
def test_posterior_and_expected_improvement_match(axes):
    cands = _grid(axes)
    rng = np.random.default_rng(0)
    opt = bayes.GPOptimizer(cands, bayes.AxisEncoder(axes), seed=3)
    jopt = jax_bayes.GPOptimizer(cands, jax_bayes.AxisEncoder(axes), seed=3)
    for _ in range(min(6, len(cands) - 1)):
        i, ji = opt.suggest(), jopt.suggest()
        assert i == ji
        y = float(rng.standard_normal())
        opt.observe(i, y)
        jopt.observe(ji, y)
        if len(opt.ys) >= 2:
            rest = [k for k in range(len(cands)) if k not in opt.visited]
            mu, sd = opt._posterior(opt._X[rest])
            jmu, jsd = jopt._posterior(jopt._X[rest])
            np.testing.assert_allclose(mu, jmu, rtol=0, atol=1e-12)
            np.testing.assert_allclose(sd, jsd, rtol=0, atol=1e-12)
    z = np.linspace(-3, 3, 13)
    np.testing.assert_allclose(bayes._norm_cdf(z), jax_bayes._norm_cdf(z), rtol=0, atol=1e-12)
    np.testing.assert_allclose(bayes._norm_pdf(z), jax_bayes._norm_pdf(z), rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_whole_optimise_run_matches(seed):
    lrs = [10 ** -e for e in (2, 2.5, 3, 3.5, 4, 4.5)]
    gammas = [0.9, 0.95, 0.99, 0.995, 0.999]
    cands = [{"lr": lr, "gamma": g} for lr in lrs for g in gammas]

    def f(c):
        return -((np.log10(c["lr"]) + 3) ** 2) - 50 * (c["gamma"] - 0.99) ** 2

    res = bayes.optimise(cands, {"lr": lrs, "gamma": gammas}, f, budget=12, seed=seed)
    jres = jax_bayes.optimise(cands, {"lr": lrs, "gamma": gammas}, f, budget=12, seed=seed)
    assert [c for c, _ in res["history"]] == [c for c, _ in jres["history"]]
    np.testing.assert_allclose([y for _, y in res["history"]], [y for _, y in jres["history"]], rtol=0, atol=1e-12)
    assert res["best"] == jres["best"] and res["best_value"] == jres["best_value"]


SPEC = {
    "env.name": "matrix-coordination",
    "env.time_limit": 1,
    "env.parallel_envs": 8,
    "+algorithm": "idqn",
    "algorithm.model.layers": "[8,8]",
    "algorithm.total_steps": 300,
    "algorithm.training_start": 32,
    "algorithm.buffer_size": 128,
    "algorithm.batch_size": 8,
    "algorithm.eval_interval": 100,
    "algorithm.eval_episodes": 4,
    "algorithm.lr": [0.0003, 0.001],
    "algorithm.gamma": [0.9, 0.99],
}


def test_bayes_cli_writes_the_jax_result(tmp_path):
    spec = tmp_path / "spec.yaml"
    spec.write_text(yaml.safe_dump({**SPEC, "device": "cpu"}))
    jspec = tmp_path / "jspec.yaml"
    jspec.write_text(yaml.safe_dump(SPEC))
    tail = ["--seeds", "2", "bayes", "--budget", "2", "--bo-seed", "5", "--yes"]
    search.main(["run", "--config", str(spec), *tail, "--output", str(tmp_path / "port")])
    r = CliRunner().invoke(search_cli(), ["run", "--config", str(jspec), *tail, "--output", str(tmp_path / "jax")],
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    got, ref = (json.loads((tmp_path / d / "bayes_result.json").read_text()) for d in ("port", "jax"))
    assert set(got) == set(ref) == {"best", "best_value", "evaluations", "candidates", "metric"}
    assert (got["evaluations"], got["candidates"], got["metric"]) == (ref["evaluations"], ref["candidates"],
                                                                      ref["metric"]) == (2, 4, "mean_episode_returns")
    assert np.isfinite(got["best_value"])

    def trials(side):
        return [{k: v for k, v in yaml.safe_load((d / "config.yaml").read_text())["algorithm"].items()
                 if k in ("lr", "gamma")} for d in sorted((tmp_path / side).glob("trial_*/seed_0"))]

    # the first two proposals are the BO seed's random draws: the same trials
    assert trials("port") == trials("jax") and len(trials("port")) == 2
    assert len(sorted((tmp_path / "port").glob("trial_*/seed_*/results.csv"))) == 4


def search_cli():
    from codebase_tpu.search import cli

    return cli


def test_read_metric_drops_empty_and_nan_cells(tmp_path):
    path = tmp_path / "results.csv"
    path.write_text("environment_steps,loss,mean_episode_returns\n1,,0.5\n2,0.1,nan\n3,0.2,1.5\n4,0.3,\n")
    assert search.read_metric(path, "mean_episode_returns") == [0.5, 1.5]
    assert search.read_metric(path, "loss") == [0.1, 0.2, 0.3]
    with pytest.raises(KeyError):
        search.read_metric(path, "nosuch")
