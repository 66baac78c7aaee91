"""Config system: YAML presets + dot-path CLI overrides.

Same surface as the JAX package's config layer:

- `configs/default.yaml` holds global defaults (here also `device`),
- `+algorithm=<name>` merges `configs/algorithm/<name>.yaml`, which may patch
  both `algorithm` and `env` keys,
- algorithm presets may declare `defaults: [other]` inheritance,
- `key.sub=value` CLI tokens override any path, values parsed as YAML.

Algorithm names resolve through an explicit registry (`algos/registry.py`).
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml

CONFIG_DIR = Path(__file__).parent / "configs"


class Config:
    """Attribute/namespace view over a nested dict."""

    def __init__(self, data: Dict[str, Any]):
        object.__setattr__(self, "_data", data)

    def __getattr__(self, name):
        data = object.__getattribute__(self, "_data")
        if name not in data:
            raise AttributeError(f"config has no key {name!r}; keys: {sorted(data)}")
        v = data[name]
        return Config(v) if isinstance(v, dict) else v

    def __getitem__(self, name):
        return getattr(self, name)

    def __setattr__(self, name, value):
        self._data[name] = value._data if isinstance(value, Config) else value

    def __contains__(self, name):
        return name in self._data

    def get(self, name, default=None):
        v = self._data.get(name, default)
        return Config(v) if isinstance(v, dict) else v

    def keys(self):
        return self._data.keys()

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)

    def to_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def __repr__(self):
        return f"Config({self._data!r})"


def _deep_merge(base: Dict, patch: Dict) -> Dict:
    out = dict(base)
    for k, v in patch.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _set_path(data: Dict, path: str, value: Any):
    keys = path.split(".")
    node = data
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ValueError(f"cannot override through non-dict key {k!r} in {path!r}")
    node[keys[-1]] = value


def load_algorithm_preset(name: str, config_dir: Path = CONFIG_DIR) -> Dict:
    """Load an algorithm preset, resolving `defaults` inheritance. `name` is a
    preset under `configs/algorithm/` or a path to a user-owned yaml."""
    if name.endswith((".yaml", ".yml")) or "/" in name:
        path = Path(name)
        if not path.exists():
            raise ValueError(f"algorithm preset file not found: {name!r}")
    else:
        path = config_dir / "algorithm" / f"{name}.yaml"
    if not path.exists():
        available = sorted(p.stem for p in (config_dir / "algorithm").glob("*.yaml"))
        raise ValueError(f"unknown algorithm {name!r}; available: {available}")
    preset = yaml.safe_load(path.read_text()) or {}
    bases = preset.pop("defaults", [])
    merged: Dict = {}
    for base_name in bases:
        merged = _deep_merge(merged, load_algorithm_preset(base_name, config_dir))
    return _deep_merge(merged, preset)


def _parse_value(text: str) -> Any:
    """YAML-parse an override value; also accept bare scientific notation
    like `1e-5`, which YAML 1.1 treats as a string."""
    value = yaml.safe_load(text)
    if isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            return value
    return value


def load_config(argv: Optional[List[str]] = None, config_dir: Path = CONFIG_DIR) -> Config:
    """Build a config from default.yaml + `+algorithm=` preset + overrides
    (`+algorithm=idqn`, `env.name=...`, `algorithm.lr=1e-4`, `device=cpu`)."""
    argv = list(argv or [])
    data = yaml.safe_load((config_dir / "default.yaml").read_text())

    algo = None
    overrides = []
    for tok in argv:
        if "=" not in tok:
            raise ValueError(f"malformed override (expected key=value): {tok!r}")
        key, val = tok.split("=", 1)
        if key in ("+algorithm", "algorithm"):
            algo = val
        else:
            overrides.append((key.lstrip("+"), _parse_value(val)))

    if algo is not None:
        data = _deep_merge(data, load_algorithm_preset(algo, config_dir))

    for key, val in overrides:
        _set_path(data, key, val)

    return Config(data)
