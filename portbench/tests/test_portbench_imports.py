"""Nothing the benchmark runs is of the JAX side, by whole top-level
names, and the reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "codebase_tpu"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT) for p in ROOT.rglob("*.py") if "tests" not in p.parts),
                         ids=str)
def test_harness_sources(path):
    names = imported(ROOT / path)
    assert not names & JAX_SIDE
    if path.parts[0] == "reference":
        assert "codebase_tpu_torch" not in names


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "codebase_tpu_torchlike", sys)
    assert "codebase_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_a_run_loads_nothing_of_the_jax_side():
    code = ("import sys; sys.path.insert(0, '.'); from portbench import run; "
            "from portbench.tests.tiny import tiny_workload; "
            "r, _ = run.run_cell('idqn_rnn_lbf.collect', 3, 0.2, True, 'cpu', workload=tiny_workload()); "
            "print(r['correct'], run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "True []"
