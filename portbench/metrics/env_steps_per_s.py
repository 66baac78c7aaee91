"""Env steps collected in the window over the window's seconds.

The steps are what the train state's `env_steps` adds over the window's
iterations: the DQN family counts the filled steps; the actor-critic family
counts each iteration's longest episode times its envs (`algos/ac.py`), the
steps after a shorter episode ended included. The window starts after a
device sync and ends in one. All the work over all the time: no best
window, no median of chunks.
"""

NAME = "env_steps_per_s"
UNIT = "env-steps/s"
LAYER = "end to end"
MOVES = "env_steps_per_s"
SOURCE = "host_clock"


def read(ctx):
    w = ctx["window"]
    return w["env_steps"] / w["seconds"]
