"""Device milliseconds per traced iteration inside the program's range of
the update, as the cell's family names it (`families/<family>.py`
`RANGES["updates"]`: `dqn/updates`, `ac/update`): the time of the device
operations whose start lies in the range's device-side span."""

NAME = "updates_device_ms"
UNIT = "ms"
LAYER = "update"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"
LAYER_KEY = "updates"


def read(ctx):
    t, name = ctx["trace"], ctx["ranges"].get(LAYER_KEY)
    if not t or not name or not t["range_us_per_iter"].get(name):
        return None
    return t["range_us_per_iter"][name] / 1e3
