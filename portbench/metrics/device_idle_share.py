"""The share of an iteration in which the device runs nothing, in percent:
1 - (busy time per iteration in the traced stretch, the union of the
device operations' spans) / (iteration time of the untraced window). The
traced stretch runs the host several-fold slower, so its own idle time is
not used."""

NAME = "device_idle_share"
UNIT = "%"
LAYER = "device"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"


def read(ctx):
    t = ctx["trace"]
    if not t or not t["busy_us_per_iter"]:
        return None
    w = ctx["window"]
    iteration_us = w["seconds"] / w["iters"] * 1e6
    return 100.0 * (1.0 - t["busy_us_per_iter"] / iteration_us)
