"""The port's analysis (`codebase_tpu_torch/analyze.py`, `utils/stats.py`,
`utils/postprocessing/`) against the JAX package's on one `results.csv`
tree: a run of the port's train CLI beside synthetic runs (two envs, two
lr groups, three seeds, empty cells and integer columns). Groups, names,
integer columns and the `summary` and `best` output are equal. The float
arrays are the numbers of the files exactly (pandas' `round_trip` parse);
the JAX package reads them with pandas' default parser, which is not
correctly rounded (up to 27 ulp, 1e-15 relative, off on this tree), so its
metric arrays and stats matrices agree with the port's to rtol 1e-14."""

import math

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from codebase_tpu import analyze as jax_analyze
from codebase_tpu.utils import stats as jax_stats
from codebase_tpu.utils.postprocessing import load_data as jax_load_data
from codebase_tpu_torch import analyze, run
from codebase_tpu_torch.utils import stats
from codebase_tpu_torch.utils.postprocessing import export_multirun, hiplot_fetcher, load_data

torch.set_num_threads(2)
HEADER = ["environment_steps", "loss", "mean_episode_length", "mean_episode_returns", "updates"]  # the logger's order


def _write_run(path, env, lr, seed, rng, rows=6):
    path.mkdir(parents=True)
    config = {"seed": seed, "env": {"name": env, "time_limit": 25},
              "algorithm": {"name": "idqn", "lr": lr, "gamma": 0.99}}
    (path / "config.yaml").write_text(yaml.safe_dump(config))
    lines = [",".join(HEADER)]
    for i in range(rows):
        ret = rng.normal(lr * 1e3, 1.0)
        loss = "" if i == 0 else repr(float(rng.random()))  # no update yet in the first row
        lines.append(f"{(i + 1) * 1000},{loss},{float(rng.integers(5, 26))!r},{ret!r},{i * 8}")
    (path / "results.csv").write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    rng = np.random.default_rng(0)
    for env in ("lbforaging:Foraging-8x8-2p-3f-v3", "rware-tiny-2ag-v2"):
        for lr in (3e-4, 1e-3):
            for seed in range(3):
                _write_run(root / env.replace(":", "_") / f"lr{lr}" / f"seed{seed}", env, lr, seed, rng)
    # and a run of the port's train CLI, as it writes them
    run.main(["+algorithm=idqn", "env.name=matrix-coordination", "env.time_limit=1", "env.parallel_envs=8",
              "algorithm.total_steps=400", "algorithm.training_start=16", "algorithm.buffer_size=128",
              "algorithm.batch_size=8", "algorithm.eval_interval=150", "algorithm.eval_episodes=4", "seed=0",
              "device=cpu", f"run_dir={root / 'port' / 'run0'}"])
    return root


def test_groups_names_and_metrics_equal_the_jax_package(tree):
    for minimal in (True, False):
        ref = jax_load_data.load_and_group_runs(tree, minimal)
        got = load_data.load_and_group_runs(tree, minimal)
        assert [g.name for g in got] == [g.name for g in ref]
        for g, r in zip(got, ref):
            assert [run.path for run in g.runs] == [run.path for run in r.runs]
            assert g.env_name == r.env_name and g.config == r.config
            for key in r.runs[0].data:
                got_values, ref_values = g.get_metric(key), r.get_metric(key)
                assert got_values.dtype == ref_values.dtype, key
                if got_values.dtype.kind == "f":
                    np.testing.assert_allclose(got_values, ref_values, rtol=1e-14, atol=0, err_msg=key)
                else:
                    np.testing.assert_array_equal(got_values, ref_values, err_msg=key)
                for run_got in g.runs:
                    exact = pd.read_csv(run_got.path / "results.csv", float_precision="round_trip")
                    np.testing.assert_array_equal(np.array(run_got.data[key]), exact[key].to_numpy(), err_msg=key)
    assert len(load_data.load_and_group_runs(tree)) == 5
    port_run = load_data.Run.from_path(tree / "port" / "run0")
    assert port_run.config["algorithm"]["name"] == "idqn" and len(port_run.data["environment_steps"]) >= 1
    assert math.isnan(load_data.read_columns(tree / "rware-tiny-2ag-v2" / "lr0.001" / "seed0" / "results.csv")["loss"][0])


def test_stats_matrices_equal_the_jax_package(tree, tmp_path):
    layout = tmp_path / "layout"
    for env in ("lbf", "rware"):
        src = tree / ("lbforaging_Foraging-8x8-2p-3f-v3" if env == "lbf" else "rware-tiny-2ag-v2") / "lr0.001"
        for i, seed_dir in enumerate(sorted(src.iterdir())):
            (layout / env / "idqn" / f"run{i}").mkdir(parents=True)
            (layout / env / "idqn" / f"run{i}" / "results.csv").write_bytes((seed_dir / "results.csv").read_bytes())
    folders, algos = [str(layout / "lbf"), str(layout / "rware")], ["idqn", "idqn"]
    metric = ["mean_episode_returns"] * 2
    eff, ref = stats.make_agg_metrics_efficiency(folders, algos, metric), jax_stats.make_agg_metrics_efficiency(
        folders, algos, metric)
    assert eff["idqn"].shape == (3, 2, 6)
    # pandas' default parse, as above
    np.testing.assert_allclose(eff["idqn"], ref["idqn"], rtol=1e-14, atol=0)
    args = (folders, ["idqn", "idqn"], metric, [3000, 3000], ["environment_steps"] * 2)
    np.testing.assert_allclose(stats.make_agg_metrics_intervals(*args)["idqn"],
                               jax_stats.make_agg_metrics_intervals(*args)["idqn"], rtol=1e-14, atol=0)
    with pytest.raises(ValueError, match="step and step_metric"):
        stats.make_agg_metrics_intervals(folders, algos, metric)


@pytest.mark.parametrize("command", [["summary"], ["summary", "--last-k", "2"], ["best"],
                                     ["best", "--last-k", "2", "--no-print-config"]])
def test_summary_and_best_print_what_the_jax_cli_prints(tree, capsys, command):
    from click.testing import CliRunner

    ref = CliRunner().invoke(jax_analyze.cli, [command[0], "--source", str(tree), *command[1:]])
    assert ref.exit_code == 0, ref.output
    assert analyze.main([command[0], "--source", str(tree), *command[1:]]) == 0
    assert capsys.readouterr().out == ref.output


def test_best_returns_the_winners_and_errors_exit_like_the_jax_cli(tree, capsys):
    winners = analyze.best(tree, print_config=False)
    assert winners["rware-tiny-2ag-v2"][0] == "IDQN (algorithm.lr=0.001 env.name=rware-tiny-2ag-v2 env.time_limit=25)"
    capsys.readouterr()
    assert analyze.main(["best", "--source", str(tree), "--metric", "nosuch"]) == 1
    assert "Error: metric 'nosuch' missing from groups" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exit_info:
        analyze.main(["best", "--source", str(tree / "missing")])
    assert exit_info.value.code == 2


def test_plot_and_export_need_their_packages(tree, tmp_path, monkeypatch):
    written = analyze.plot(tree, save_dir=tmp_path / "plots")
    assert len(written) == 3 and all(p.exists() for p in written)
    configs, df = export_multirun.load_multirun(tree)
    assert df.columns.nlevels == 4 and len(configs) == 5
    import builtins

    real_import = builtins.__import__

    def without(*names):
        def fake(name, *args, **kwargs):
            if name.split(".")[0] in names:
                raise ImportError(f"No module named {name!r}")
            return real_import(name, *args, **kwargs)

        return fake

    monkeypatch.setattr(builtins, "__import__", without("matplotlib"))
    with pytest.raises(ImportError, match="needs matplotlib"):
        analyze.plot(tree)
    monkeypatch.setattr(builtins, "__import__", without("pandas"))
    with pytest.raises(ImportError, match="needs pandas"):
        export_multirun.load_multirun(tree)
    monkeypatch.setattr(builtins, "__import__", without("hiplot"))
    with pytest.raises(ImportError, match="needs hiplot"):
        hiplot_fetcher.experiment_fetcher("exp://x.h5/env/alg")
