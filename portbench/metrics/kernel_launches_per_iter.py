"""Device kernels per traced iteration (copies and sets left out). It
repeats nearly exactly from run to run; a CUDA graph or a fused env step
would cut it."""

NAME = "kernel_launches_per_iter"
UNIT = "launches/iter"
LAYER = "host loop"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"


def read(ctx):
    t = ctx["trace"]
    return t["kernels_per_iter"] if t and t["kernels_per_iter"] else None
