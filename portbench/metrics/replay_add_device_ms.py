"""Device milliseconds per traced iteration inside the program's range of
the replay insert, as the cell's family names it (`families/<family>.py`
`RANGES["replay_add"]`: `dqn/replay_add`; the actor-critic family keeps no
replay and reads nothing): the time of the device operations whose start
lies in the range's device-side span."""

NAME = "replay_add_device_ms"
UNIT = "ms"
LAYER = "replay"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"
LAYER_KEY = "replay_add"


def read(ctx):
    t, name = ctx["trace"], ctx["ranges"].get(LAYER_KEY)
    if not t or not name or not t["range_us_per_iter"].get(name):
        return None
    return t["range_us_per_iter"][name] / 1e3
