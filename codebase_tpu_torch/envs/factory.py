"""Environment factory: name string -> wrapped `Environment` spec.

Wrapper order follows the JAX package: base -> TimeLimit -> (ObserveID ->
StandardiseReward -> named wrappers, which wait for a later slice).
"""

from __future__ import annotations

import dataclasses

from codebase_tpu_torch.envs import wrappers as W
from codebase_tpu_torch.envs.api import Environment
from codebase_tpu_torch.envs.lbforaging import parse_lbf_name


def make_base_env(name: str) -> Environment:
    short = name.split(":")[-1]
    if short.startswith("Foraging"):
        return parse_lbf_name(name)
    if short.startswith("rware") or "smaclite" in name.lower() or short.startswith("matrix"):
        raise NotImplementedError(
            f"environment {name!r} is not ported yet "
            "(ROADMAP.md Queue 1: RWARE, SMAClite with masks, and matrix games)"
        )
    raise ValueError(f"Unknown environment name: {name}")


def make_env(
    name: str,
    time_limit: int,
    clear_info: bool = False,
    observe_id: bool = False,
    standardise_rewards: bool = False,
    wrappers=None,
    **kwargs,
) -> Environment:
    del clear_info  # there is no info dict to clear
    if observe_id or standardise_rewards or wrappers:
        raise NotImplementedError(
            "observe_id, standardise_rewards and named wrappers are not ported yet "
            "(ROADMAP.md Queue 1: VDN/QMIX and standardisation)"
        )
    env = make_base_env(name)
    if kwargs:
        env = dataclasses.replace(env, **kwargs)
    if time_limit:
        env = W.TimeLimit(env, limit=int(time_limit))
    return env
