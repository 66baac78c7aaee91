"""Algorithm registry: name -> train entry point
`main(env, eval_env, logger, time_limit, cfg, device) -> final state`.

The value-based family (IDQN, VDN, QMIX) is ported; the actor-critic
family waits (ROADMAP.md Queue 1)."""

from __future__ import annotations


def _dqn(env, eval_env, logger, time_limit, cfg, device):
    from codebase_tpu_torch.algos.dqn_train import main

    return main(env, eval_env, logger, time_limit, cfg, device)


ALGORITHMS = {"idqn": _dqn, "vdn": _dqn, "qmix": _dqn}

NOT_PORTED = {
    "ia2c": "the actor-critic family",
    "maa2c": "the actor-critic family",
    "ippo": "the actor-critic family",
    "mappo": "the actor-critic family",
}


def get_algorithm(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported yet (ROADMAP.md Queue 1: {NOT_PORTED[name]})"
        )
    if name not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {name!r}; available: {sorted(ALGORITHMS)}")
    return ALGORITHMS[name]
