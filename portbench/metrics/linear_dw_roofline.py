"""The f32 weight-gradient kernels' share of their roofline, in percent: the
least time of the weight gradients the program sends to its hand-written
kernels an iteration, over the device time per traced iteration of every
operation whose name holds `grouped_dw` (the split-K kernels and their
reduction).

The weight gradients: the program's `("linear/dw", "kernel", (G, K, M, N))`
counters (each a dW[g] = x[g]^T dy[g] of G groups of K rows, M x N),
counted since the process started, over the train iterations since then
(`ctx["iterations"]`: the DQN family's `dqn/iterations` counter, as
`host_syncs_per_iter` reads it; for the actor-critic family, which counts
none, the iterations the harness ran). A product's least time is the larger of
its operations at the tensor cores' 3xTF32 rate (3 * 2GKMN over the TF32
peak) and its f32 bytes, x and dy read once and dW written once
(4G(KM + KN + MN)), at the HBM rate: the rule of `counts.gru_bounds`,
whichever kernel variant forms the product. A run without a trace, peaks,
the counter registry or a kernel-routed weight gradient reads nothing."""

NAME = "linear_dw_roofline"
UNIT = "%"
LAYER = "kernels"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"
KERNELS = "grouped_dw"


def least_seconds(G: int, K: int, M: int, N: int, peaks: dict) -> float:
    """The least time of one weight gradient on the card of `peaks`."""
    t_ops = 3 * 2.0 * G * K * M * N / peaks["tf32_flops"]
    t_bytes = 4.0 * G * (K * M + K * N + M * N) / peaks["hbm_bytes_per_s"]
    return max(t_ops, t_bytes)


def read(ctx):
    t, peaks = ctx.get("trace"), ctx.get("peaks")
    if not t or not peaks:
        return None
    from codebase_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    counts = profiling.counters()
    iters = ctx.get("iterations")
    if not iters:
        return None
    least = sum(n * least_seconds(*key[2], peaks) for key, n in counts.items()
                if isinstance(key, tuple) and key[:2] == ("linear/dw", "kernel")) / iters
    device_s = sum(us for name, (_, us) in t["by_name"].items() if KERNELS in name) / 1e6
    if not least or not device_s:
        return None
    return 100.0 * least / device_s
