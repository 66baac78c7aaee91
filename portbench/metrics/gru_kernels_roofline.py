"""The GRU layer's share of its roofline, in percent: the least time of the
GRU calls an iteration makes (`counts.gru_bounds`, from the shapes and the
steps actually run), over the device time of the GRU kernels per traced
iteration.

The calls: one forward at T=1 over the E envs for each rollout step run
(the forward launches beyond the updates' two each), and per update the
online and target forwards over (T+1, B) and one backward."""

from portbench import counts

NAME = "gru_kernels_roofline"
UNIT = "%"
LAYER = "kernels"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"
KERNELS = ("gru_fwd_kernel", "gru_bwd_kernel", "gru_dw_kernel", "gru_reduce_kernel")


def read(ctx):
    t, peaks = ctx["trace"], ctx["peaks"]
    if not t or not peaks:
        return None
    s = ctx["shapes"]
    calls = {k: sum(c for n, (c, _) in t["by_name"].items() if k in n) for k in KERNELS}
    device_s = sum(us for n, (_, us) in t["by_name"].items() if any(k in n for k in KERNELS)) / 1e6
    if not device_s:
        return None
    rollout_steps = calls["gru_fwd_kernel"] - 2 * s["U"]
    fwd_roll, _ = counts.gru_bounds("fwd", s["G"], 1, s["E"], s["H"], peaks)
    fwd_upd, _ = counts.gru_bounds("fwd", s["G"], s["T"] + 1, s["B"], s["H"], peaks)
    bwd_upd, _ = counts.gru_bounds("bwd", s["G"], s["T"] + 1, s["B"], s["H"], peaks)
    least = rollout_steps * fwd_roll + s["U"] * (2 * fwd_upd + bwd_upd)
    return 100.0 * least / device_s
