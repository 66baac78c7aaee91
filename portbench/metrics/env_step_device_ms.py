"""Device milliseconds per traced iteration inside the program's range
`env/step`: the time of the device operations whose start lies in the range's
device-side span."""

NAME = "env_step_device_ms"
UNIT = "ms"
LAYER = "envs"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"
RANGE = "env/step"


def read(ctx):
    t = ctx["trace"]
    if not t or not t["range_us_per_iter"].get(RANGE):
        return None
    return t["range_us_per_iter"][RANGE] / 1e3
