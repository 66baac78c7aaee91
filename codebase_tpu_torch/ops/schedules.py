"""Exploration schedules as functions of the host step counter."""

from __future__ import annotations

import math


def epsilon_schedule(
    decay_style: str,
    decay_over: float,
    eps_start: float,
    eps_end: float,
    exp_decay_rate: float,
    total_steps: int,
):
    """Build an epsilon schedule fn: step -> epsilon (float).

      linear:      eps_end + (eps_start-eps_end) * (1 - step/(total*decay_over)),
                   floored at eps_end.
      exponential: eps_end + (eps_start-eps_end) * exp(-k*step) with
                   k = (eps_start-eps_end) / (total*decay_over) * exp_decay_rate,
                   floored at eps_end.
    """
    if decay_style in ("linear", "lin"):
        style = "linear"
    elif decay_style in ("exponential", "exp"):
        style = "exponential"
    else:
        raise ValueError("decay_style must be one of 'linear' or 'exponential'")
    if not (0 <= eps_start <= 1 and 0 <= eps_end <= 1):
        raise ValueError("eps must be in [0, 1]")
    if eps_start < eps_end:
        raise ValueError("eps_start must be >= eps_end")
    if not 0 < decay_over <= 1:
        raise ValueError("decay_over must be in (0, 1]")
    if total_steps <= 0:
        raise ValueError("total_steps must be > 0")
    if exp_decay_rate <= 0:
        raise ValueError("exp_decay_rate must be > 0")

    span = float(total_steps) * float(decay_over)

    if style == "linear":

        def schedule(step):
            return max(eps_end + (eps_start - eps_end) * (1.0 - float(step) / span), eps_end)

    else:
        k = (eps_start - eps_end) / span * exp_decay_rate

        def schedule(step):
            return max(eps_end + (eps_start - eps_end) * math.exp(-k * float(step)), eps_end)

    return schedule
