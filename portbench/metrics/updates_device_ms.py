"""Device milliseconds per traced iteration inside the program's range
`dqn/updates`: the time of the device operations whose start lies in the range's
device-side span."""

NAME = "updates_device_ms"
UNIT = "ms"
LAYER = "update"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"
RANGE = "dqn/updates"


def read(ctx):
    t = ctx["trace"]
    if not t or not t["range_us_per_iter"].get(RANGE):
        return None
    return t["range_us_per_iter"][RANGE] / 1e3
