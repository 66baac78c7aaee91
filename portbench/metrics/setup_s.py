"""Seconds from the start of the process to the first timed iteration:
imports, the kernel library (built once into the checkout, loaded after),
config, envs, the train state and its weights on the device, the checked
first iteration and the warm-up."""

NAME = "setup_s"
UNIT = "s"
LAYER = "end to end"
MOVES = "setup_s"
SOURCE = "host_clock"


def read(ctx):
    return ctx["setup_s"]
