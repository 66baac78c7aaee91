"""Environment factory: name string -> wrapped `Environment` spec.

Wrapper order follows the JAX package: base -> TimeLimit -> ObserveID ->
StandardiseReward -> named wrappers. `clear_info` is accepted and ignored
(there is no info dict to clear).
"""

from __future__ import annotations

import dataclasses
import warnings

from codebase_tpu_torch.envs import wrappers as W
from codebase_tpu_torch.envs.api import Environment
from codebase_tpu_torch.envs.lbforaging import parse_lbf_name
from codebase_tpu_torch.envs.matrix import parse_matrix_name
from codebase_tpu_torch.envs.rware import parse_rware_name
from codebase_tpu_torch.envs.smaclite import parse_smaclite_name


def make_base_env(name: str) -> Environment:
    short = name.split(":")[-1]
    if short.startswith("Foraging"):
        return parse_lbf_name(name)
    if short.startswith("rware"):
        return parse_rware_name(name)
    if "smaclite" in name.lower():
        return parse_smaclite_name(name)
    if short.startswith("matrix"):
        return parse_matrix_name(name)
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
    env = make_base_env(name)
    if kwargs:
        env = dataclasses.replace(env, **kwargs)
    if time_limit:
        env = W.TimeLimit(env, limit=int(time_limit))
    if observe_id:
        env = W.ObserveID(env)
    if standardise_rewards:
        env = W.StandardiseReward(env)
    reward_standardised = bool(standardise_rewards)
    for wname in wrappers or []:
        if wname not in W.NAMED_WRAPPERS:
            raise ValueError(
                f"Unknown wrapper {wname!r}. Supported named wrappers: "
                f"{sorted(W.NAMED_WRAPPERS)}. Arbitrary gym.wrappers cannot "
                "be applied to the batched envs; equivalents are mapped by "
                "name (e.g. gym's NormalizeReward -> StandardiseReward, "
                "RecordEpisodeStatistics/ClearInfo are always-on/no-op here)."
            )
        cls = W.NAMED_WRAPPERS[wname]
        if cls is W.StandardiseReward:
            if reward_standardised:
                warnings.warn(
                    f"wrapper {wname!r} skipped: reward standardisation is "
                    "already in the stack (standardise_rewards flag or an "
                    "earlier named wrapper)"
                )
                continue
            if wname == "NormalizeReward":
                # gym's NormalizeReward divides by a running std of the
                # discounted return, with no mean subtraction: the nearest
                # equivalent here is a different reward shaping
                warnings.warn(
                    "gym wrapper 'NormalizeReward' is approximated by "
                    "StandardiseReward (streaming mean/std reward "
                    "standardisation). gym's version divides by the running "
                    "std of the discounted return without mean subtraction; "
                    "trained reward magnitudes will differ from the gym "
                    "wrapper's."
                )
            reward_standardised = True
        env = cls(env)
    return env
