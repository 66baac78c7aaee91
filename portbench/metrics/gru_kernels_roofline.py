"""The GRU layer's share of its roofline, in percent: the least time of the
GRU calls an iteration makes (`counts.gru_bounds` for each call of the
cell's family's call model, `families/<family>.py` `gru_least_seconds`,
from the shapes and the rollout steps actually run), over the device time of
the GRU kernels per traced iteration.

The DQN family's calls: one forward at T=1 over the E envs for each rollout
step run (the forward launches beyond the updates' two each), and per update
the online and target forwards over (T+1, B) and one backward. The
actor-critic family's: the actor's forward at T=1 for each rollout step
run, the target critic's forward over (T+1, E), for PPO the pre-update
actor forward over (T, E), and each epoch's forward and backward of the
actor and the critic over (T, E)."""

NAME = "gru_kernels_roofline"
UNIT = "%"
LAYER = "kernels"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"
KERNELS = ("gru_fwd_kernel", "gru_bwd_kernel", "gru_dw_kernel", "gru_reduce_kernel")


def read(ctx):
    t, least_seconds = ctx["trace"], ctx.get("gru_least_seconds")
    if not t or not least_seconds:
        return None
    calls = {k: sum(c for n, (c, _) in t["by_name"].items() if k in n) for k in KERNELS}
    device_s = sum(us for n, (_, us) in t["by_name"].items() if any(k in n for k in KERNELS)) / 1e6
    if not device_s:
        return None
    return 100.0 * least_seconds(calls) / device_s
