"""Import guard: the port and `chip_smoke.py` import no JAX and nothing of
the JAX package, and the port imports and runs a CPU forward without
`triton` or `nvcc`."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "codebase_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "codebase_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_multi_gpu_modules_import_torch_and_nothing_of_jax():
    """The data-parallel slice (`parallel/`, `scaling_bench.py`) and the
    rank functions its tests spawn build on `torch` (`torch.distributed`)
    alone: a spawned rank imports no JAX."""
    files = sorted((ROOT / "codebase_tpu_torch" / "parallel").glob("*.py")) + [
        ROOT / "codebase_tpu_torch" / "scaling_bench.py", ROOT / "tests" / "torch_dist_worker.py"]
    assert {p.name for p in files} >= {"mesh.py", "scaling_bench.py", "torch_dist_worker.py"}
    for path in files:
        mods = list(_imported_modules(path))
        assert not [m for m in mods if m.split(".")[0] in FORBIDDEN], path
        if path.name != "__init__.py":
            assert any(m.split(".")[0] == "torch" for m in mods), path
    assert "torch.distributed" in list(_imported_modules(ROOT / "codebase_tpu_torch" / "parallel" / "mesh.py"))


def test_port_needs_no_msgpack_and_imports_imageio_only_in_the_video_encoder():
    """A GPU host need not have either package: the port writes msgpack with
    its own codec and imports imageio lazily, inside `VideoRecorder.save`."""
    files = sorted((ROOT / "codebase_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [f"{p.relative_to(ROOT)}: {m}" for p in files for m in _imported_modules(p) if m.split(".")[0] == "msgpack"]
    assert not bad, bad
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:  # module level
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            assert not any(n.split(".")[0] == "imageio" for n in names), f"{path.relative_to(ROOT)} imports imageio"
    video = (ROOT / "codebase_tpu_torch" / "utils" / "video.py").read_text()
    assert "import imageio" in video


# the one module whose job needs pandas (the JAX package's dataframe
# export); it imports pandas inside the function that uses it, so that
# importing it needs none (test_package_imports_and_runs_on_cpu_without_triton_or_nvcc)
PANDAS_EXPORT = ROOT / "codebase_tpu_torch" / "utils" / "postprocessing" / "export_multirun.py"


def test_port_needs_no_click_or_pandas():
    """The card's machine has neither: the search and analysis CLIs parse
    with argparse and read results.csv with csv. Only the dataframe export
    takes pandas, and not at module level."""
    files = sorted((ROOT / "codebase_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [f"{p.relative_to(ROOT)}: {m}" for p in files for m in _imported_modules(p)
           if m.split(".")[0] in ("click", "pandas") and not (p == PANDAS_EXPORT and m == "pandas")]
    assert not bad, bad
    module_level = [n for n in ast.parse(PANDAS_EXPORT.read_text()).body if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any(getattr(a, "name", "") == "pandas" for n in module_level for a in n.names)


def test_package_imports_and_runs_on_cpu_without_triton_or_nvcc(tmp_path):
    """In a fresh interpreter where `triton` and `jax` cannot be imported and
    no nvcc is on PATH: import every module and run a CPU GRU forward."""
    code = f"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("triton", "jax", "jaxlib", "flax", "optax", "msgpack", "imageio", "click", "pandas") or name == "codebase_tpu" or name.startswith("codebase_tpu."):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(ROOT)!r})
import torch, codebase_tpu_torch
for m in pkgutil.walk_packages(codebase_tpu_torch.__path__, "codebase_tpu_torch."):
    importlib.import_module(m.name)
from codebase_tpu_torch.models.multi_agent import MultiAgentNetwork
from codebase_tpu_torch.ops import fused_gru, kernel_lib
net = MultiAgentNetwork([7, 7], [128, 128], [4, 4], use_rnn=True)
y, h = net(torch.zeros(2, 3, 5, 7))
assert y.shape == (2, 3, 5, 4) and h.shape == (2, 1, 5, 128)
assert kernel_lib._lib is None and fused_gru.launch_counts() == {{"fwd": 0, "bwd": 0, "fwd_wide": 0, "bwd_wide": 0, "dw": 0, "reduce": 0}}
print("ok")
"""
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}, cwd=tmp_path,
    )
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-2000:]


@pytest.mark.parametrize("name", ["bench_suite.py", "bench.py"])
def test_bench_modules_import_torch_and_nothing_of_jax(name):
    """The port's bench keeps its own copy of the lanes and the FLOPs model:
    it imports no JAX and nothing of the JAX package (not its
    `bench_suite`), and runs on `torch`."""
    path = ROOT / "codebase_tpu_torch" / name
    mods = list(_imported_modules(path))
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN], mods
    assert any(m.split(".")[0] in ("torch", "codebase_tpu_torch") for m in mods), mods
