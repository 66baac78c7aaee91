"""The whole step's share of the card's peak, in percent.

Useful flops (the cell's family's `useful_flops`, `families/<family>.py`:
the networks' products as the layers of `RNNSpec` build them, counted with
`counts.network_macs_per_row`; the rollout's forwards per collected env
step, and each train iteration's update) of the untraced window, over its
seconds, over the peak of the configuration's precision (f32: the dense
TF32 rate over three, 165 TFLOP/s on an H100 SXM at 700 W)."""

from portbench import counts

NAME = "mfu"
UNIT = "%"
LAYER = "whole step"
MOVES = "env_steps_per_s"
SOURCE = "host_clock"


def read(ctx):
    if not ctx["peaks"]:
        return None
    w, f = ctx["window"], ctx["flops"]
    flops = f["rollout_per_env_step"] * w["env_steps"] + f["updates_per_iter"] * w["iters"]
    return 100.0 * flops / w["seconds"] / counts.mfu_peak(ctx["peaks"], ctx["dtype"])
