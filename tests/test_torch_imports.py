"""Import guard: the port and `chip_smoke.py` import no JAX and nothing of
the JAX package, and the port imports and runs a CPU forward without
`triton` or `nvcc`."""

import ast
import subprocess
import sys
from pathlib import Path

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


def test_package_imports_and_runs_on_cpu_without_triton_or_nvcc(tmp_path):
    """In a fresh interpreter where `triton` and `jax` cannot be imported and
    no nvcc is on PATH: import every module and run a CPU GRU forward."""
    code = f"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("triton", "jax", "jaxlib", "flax", "optax") or name == "codebase_tpu" or name.startswith("codebase_tpu."):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(ROOT)!r})
import torch, codebase_tpu_torch
for m in pkgutil.walk_packages(codebase_tpu_torch.__path__, "codebase_tpu_torch."):
    importlib.import_module(m.name)
from codebase_tpu_torch.models.multi_agent import MultiAgentNetwork
from codebase_tpu_torch.ops import fused_gru
net = MultiAgentNetwork([7, 7], [128, 128], [4, 4], use_rnn=True)
y, h = net(torch.zeros(2, 3, 5, 7))
assert y.shape == (2, 3, 5, 4) and h.shape == (2, 1, 5, 128)
assert fused_gru._lib is None and fused_gru.launch_counts() == {{"fwd": 0, "bwd": 0, "fwd_wide": 0, "bwd_wide": 0, "dw": 0, "reduce": 0}}
print("ok")
"""
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}, cwd=tmp_path,
    )
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-2000:]
