"""Algorithm registry: name -> train entry point
`main(env, eval_env, logger, time_limit, cfg, device) -> final state`.

Both families of the JAX package are ported: the value-based (IDQN, VDN,
QMIX) and the actor-critic (IA2C, MAA2C, IPPO, MAPPO)."""

from __future__ import annotations


def _dqn(env, eval_env, logger, time_limit, cfg, device):
    from codebase_tpu_torch.algos.dqn_train import main

    return main(env, eval_env, logger, time_limit, cfg, device)


def _ac(env, eval_env, logger, time_limit, cfg, device):
    from codebase_tpu_torch.algos.ac_train import main

    return main(env, eval_env, logger, time_limit, cfg, device)


ALGORITHMS = {
    "idqn": _dqn,
    "vdn": _dqn,
    "qmix": _dqn,
    "ia2c": _ac,
    "maa2c": _ac,
    "ippo": _ac,
    "mappo": _ac,
}


def get_algorithm(name: str):
    if name not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {name!r}; available: {sorted(ALGORITHMS)}")
    return ALGORITHMS[name]
