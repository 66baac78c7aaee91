"""The port's search CLI (`codebase_tpu_torch/search.py`) against the JAX
package's (`codebase_tpu/search.py`): the spec expansion and the seeded
shuffle element for element (on sample.yaml and on specs drawn by
hypothesis), the `dry_run` text, the `vmapped` grouping, the JAX command
lines parsed unchanged, and `single` and `locally` (in this process and
with `--workers 2` subprocesses) on tiny matrix-game combinations on the
CPU."""

import io
from pathlib import Path

import pytest
import yaml
from click.testing import CliRunner
from hypothesis import given, settings
from hypothesis import strategies as st

from codebase_tpu import search as jax_search
from codebase_tpu_torch import search

ROOT = Path(__file__).resolve().parent.parent
SAMPLE = ROOT / "codebase_tpu_torch" / "configs" / "sweeps" / "sample.yaml"


def test_sample_spec_is_the_jax_one():
    assert SAMPLE.read_text() == (ROOT / "codebase_tpu" / "configs" / "sweeps" / "sample.yaml").read_text()


@pytest.mark.parametrize("seeds,shuffle", [(1, True), (2, True), (3, False)])
def test_sample_combinations_are_the_jax_ones(seeds, shuffle):
    spec = search.load_spec(SAMPLE.read_text())
    jspec = yaml.load(io.StringIO(SAMPLE.read_text()), Loader=jax_search._SweepLoader)
    assert spec == jspec
    assert search.gen_combos(spec) == jax_search.gen_combos(jspec)
    got = search.seed_and_shuffle(search.gen_combos(spec), shuffle, seeds)
    assert got == jax_search.seed_and_shuffle(jax_search.gen_combos(jspec), shuffle, seeds)
    assert len(got) == 16 * seeds


_scalar = st.one_of(st.integers(-5, 5), st.sampled_from([0.5, 1e-3, "a", "lbforaging:x", True, False]))
_key = st.sampled_from(["algorithm.lr", "algorithm.gamma", "env.name", "env.time_limit", "seed_like", "x.y"])
_leaf = st.one_of(_scalar, st.lists(_scalar, min_size=1, max_size=3))
# a tuple links its dicts; lists inside them are further grid axes
_linked = st.lists(st.dictionaries(_key, _leaf, min_size=1, max_size=2), min_size=1, max_size=3).map(tuple)
_spec = st.dictionaries(
    st.sampled_from(["a", "b", "c", "algorithm.batch_size", "tuples-1", "tuples-2"]),
    st.one_of(_leaf, st.lists(_linked, min_size=1, max_size=2)),
    max_size=4,
)


@settings(max_examples=60, deadline=None)
@given(spec=_spec, seeds=st.integers(1, 3), shuffle=st.booleans())
def test_drawn_specs_expand_as_in_the_jax_package(spec, seeds, shuffle):
    combos = search.gen_combos(spec)
    assert combos == jax_search.gen_combos(spec)
    assert search.seed_and_shuffle(combos, shuffle, seeds) == jax_search.seed_and_shuffle(combos, shuffle, seeds)


def _jax_cli(args):
    r = CliRunner().invoke(jax_search.cli, args, catch_exceptions=False)
    return r.exit_code, r.output


def _port_cli(args, capsys):
    try:
        search.main(args)
        code = 0
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


@pytest.mark.parametrize("args,count", [
    (["--seeds", "2"], 32), (["--seeds", "1", "--no-shuffle"], 16), (["--no-shuffle", "--seeds", "3"], 48), ([], 48)])
def test_dry_run_prints_the_jax_text(args, count, capsys):
    # click names the JAX command dry-run; the port takes dry_run and dry-run
    jcode, jout = _jax_cli(["run", "--config", str(SAMPLE), *args, "dry-run"])
    for mode in ("dry_run", "dry-run"):
        code, out = _port_cli(["run", "--config", str(SAMPLE), *args, mode], capsys)
        assert (code, out) == (jcode, jout) == (0, jout)
    assert jout.startswith(f"There are {count} configurations as shown below:\n")
    assert len(jout.splitlines()) == count + 1


def test_an_empty_grid_aborts_as_the_jax_cli(tmp_path, capsys):
    spec = tmp_path / "empty.yaml"
    spec.write_text("a: []\n")
    assert _port_cli(["run", "--config", str(spec), "dry_run"], capsys) == _jax_cli(
        ["run", "--config", str(spec), "dry-run"]) == (1, "No valid combinations. Aborted!\n")


GROUPING_SPEC = """
env.name: matrix-coordination
env.time_limit: 1
+algorithm: idqn
algorithm.lr: [0.001, 0.0003]
algorithm.gamma: [0.9, 0.99]
linked:
  - !!python/tuple [{algorithm.batch_size: 8}, {algorithm.target_update_interval_or_tau: [100, 300]}]
  - !!python/tuple [{algorithm.batch_size: 16}]
"""


def test_vmapped_groups_as_the_jax_cli(tmp_path, monkeypatch, capsys):
    """The same groups (residual tokens), variants in the same order, seeds
    and `group_i` lines, with training replaced by a recorder on both
    sides."""
    import codebase_tpu.sweep as jax_sweep
    import codebase_tpu.utils.compilation_cache as jax_cache
    from codebase_tpu_torch import sweep as port_sweep

    spec = tmp_path / "spec.yaml"
    spec.write_text(GROUPING_SPEC)
    seen = {"jax": [], "port": []}

    def recorder(side):
        def record(cfg, seeds, run_dir, hyper_variants=None):
            seen[side].append((cfg.to_dict()["algorithm"]["batch_size"], list(seeds), run_dir.name, hyper_variants))
            return []
        return record

    monkeypatch.setattr(jax_sweep, "run_vmapped_multiseed", recorder("jax"))
    monkeypatch.setattr(jax_cache, "enable", lambda *a, **k: None)
    monkeypatch.setattr(port_sweep, "run_vmapped_multiseed", recorder("port"))
    args = ["run", "--config", str(spec), "--seeds", "3", "vmapped", "--output", str(tmp_path / "o"), "--yes"]
    jcode, jout = _jax_cli(args)
    code, out = _port_cli(args, capsys)
    assert code == jcode == 0
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 2
    group_lines = lambda text: [ln for ln in text.splitlines() if ln.startswith("group_")]  # noqa: E731
    assert group_lines(out) == group_lines(jout)
    # batch 16: the lr x gamma grid; batch 8: also the linked tau axis
    assert [(b, len(v)) for b, _, _, v in seen["port"]] == [(16, 4), (8, 8)]
    assert all(seeds == [0, 1, 2] for _, seeds, _, _ in seen["port"])


@pytest.mark.parametrize("line", [
    "run --config {spec} --seeds 5 dry-run",
    "run --config {spec} --no-shuffle --seeds 2 single 3",
    "run --config {spec} --shuffle --seeds 1 locally --yes --workers 2",
    "run --config {spec} --seeds 4 vmapped --output out --yes",
    "run --config {spec} --seeds 2 bayes --budget 3 --output out --metric mean_episode_returns --tail 2 "
    "--bo-seed 1 --yes",
])
def test_the_jax_command_lines_parse_unchanged(line):
    """Every mode and option of the JAX CLI, as its README and its click
    options spell them."""
    args = search.build_parser().parse_args(line.format(spec="s.yaml").split())
    assert args.command == "run" and args.config == "s.yaml"
    opts = vars(args)
    if "bayes" in line:
        assert (opts["budget"], opts["metric"], opts["tail"], opts["bo_seed"], opts["yes"]) == (
            3, "mean_episode_returns", 2, 1, True)
    if "locally" in line:
        assert opts["workers"] == 2 and opts["yes"] and opts["shuffle"]
    if "single" in line:
        assert opts["index"] == 3 and not opts["shuffle"] and opts["seeds"] == 2


TINY = """
env.name: matrix-coordination
env.time_limit: 1
env.parallel_envs: 4
+algorithm: idqn
algorithm.model.layers: "[8,8]"
algorithm.total_steps: 40
algorithm.training_start: 4
algorithm.buffer_size: 16
algorithm.batch_size: 4
algorithm.eval_interval: 20
algorithm.log_interval: 20
algorithm.eval_episodes: 4
device: cpu
algorithm.lr: [0.001, 0.01]
"""


def _runs(root):
    return sorted(root.glob("outputs/**/results.csv"))


def test_single_and_locally_run_the_combinations(tmp_path, monkeypatch, capsys):
    spec = tmp_path / "tiny.yaml"
    spec.write_text(TINY)
    monkeypatch.chdir(tmp_path)
    assert _port_cli(["run", "--config", str(spec), "--seeds", "1", "single", "1"], capsys)[0] == 0
    assert len(_runs(tmp_path)) == 1
    code, out = _port_cli(["run", "--config", str(spec), "--seeds", "1", "locally", "--yes"], capsys)
    assert code == 0 and "[2/2]" in out and len(_runs(tmp_path)) == 3


def test_locally_with_two_worker_processes(tmp_path, monkeypatch, capsys):
    spec = tmp_path / "tiny.yaml"
    spec.write_text(TINY)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    code, out = _port_cli(["run", "--config", str(spec), "--seeds", "1", "locally", "--workers", "2", "--yes"], capsys)
    assert code == 0 and "done: 2/2 succeeded" in out
    runs = _runs(tmp_path)
    assert len(runs) == 2 and all(len(p.read_text().splitlines()) >= 2 for p in runs)


def test_without_yes_a_no_aborts(tmp_path, monkeypatch, capsys):
    spec = tmp_path / "tiny.yaml"
    spec.write_text(TINY)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("builtins.input", lambda prompt: "n")
    with pytest.raises(SystemExit) as exit_:
        search.main(["run", "--config", str(spec), "--seeds", "1", "locally"])
    assert exit_.value.code == 1 and capsys.readouterr().err == "Aborted!\n" and not _runs(tmp_path)
