"""Algorithm registry: name -> train entry point
`main(env, eval_env, logger, time_limit, cfg, device, shard=None) -> final
state`, `shard` this rank's part of a data-parallel run (`parallel/mesh.py`).

Both families of the JAX package are ported: the value-based (IDQN, VDN,
QMIX) and the actor-critic (IA2C, MAA2C, IPPO, MAPPO).

A user's algorithm plugs in as in the JAX package, two ways:

- `register_algorithm("my_algo", entry)` from user code before calling
  `run.main`, or
- `algorithm.entry=my_pkg.my_module:main` in the config, a dotted import
  path resolved at dispatch, beside an external preset file
  (`+algorithm=./path/to/my_algo.yaml`).

An entry takes the port's signature above (the JAX package's takes `mesh`
where the port takes `device` and `shard`).
"""

from __future__ import annotations

import importlib


def _dqn(env, eval_env, logger, time_limit, cfg, device, shard=None):
    from codebase_tpu_torch.algos.dqn_train import main

    return main(env, eval_env, logger, time_limit, cfg, device, shard)


def _ac(env, eval_env, logger, time_limit, cfg, device, shard=None):
    from codebase_tpu_torch.algos.ac_train import main

    return main(env, eval_env, logger, time_limit, cfg, device, shard)


ALGORITHMS = {
    "idqn": _dqn,
    "vdn": _dqn,
    "qmix": _dqn,
    "ia2c": _ac,
    "maa2c": _ac,
    "ippo": _ac,
    "mappo": _ac,
}


def register_algorithm(name: str, entry) -> None:
    """Register (or override) an algorithm's train entry point,
    `entry(env, eval_env, logger, time_limit, cfg, device, shard=None)`."""
    ALGORITHMS[str(name)] = entry


def _import_entry(path: str):
    """Resolve `pkg.module:fn` (or `pkg.module.fn`) to a callable."""
    module_name, sep, attr = path.partition(":")
    if not sep:
        module_name, _, attr = path.rpartition(".")
    if not module_name or not attr:
        raise ValueError(f"algorithm.entry must look like 'pkg.module:fn'; got {path!r}")
    return getattr(importlib.import_module(module_name), attr)


def get_algorithm(name: str, entry: str | None = None):
    """Look up a train entry point: an `algorithm.entry` dotted path wins,
    then the registry."""
    if entry:
        return _import_entry(str(entry))
    if name not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {name!r}; available: {sorted(ALGORITHMS)}")
    return ALGORITHMS[name]
