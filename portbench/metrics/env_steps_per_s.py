"""Env steps collected in the window over the window's seconds.

The steps are the iterations' filled steps, as the train state's
`env_steps` counts them; the window starts after a device sync and ends in
one. All the work over all the time: no best window, no median of chunks.
"""

NAME = "env_steps_per_s"
UNIT = "env-steps/s"
LAYER = "end to end"
MOVES = "env_steps_per_s"
SOURCE = "host_clock"


def read(ctx):
    w = ctx["window"]
    return w["env_steps"] / w["seconds"]
