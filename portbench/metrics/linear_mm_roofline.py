"""The f32 Linear's product kernels' share of their roofline, in percent: the
least time of the forward and input-gradient products the program sends to
its hand-written kernels an iteration, over the device time per traced
iteration of every operation whose name holds `grouped_mm`.

The products: the program's `("linear/fwd" | "linear/dx", "kernel", (G, R,
K, N))` counters (each x[g] (R x K) @ B[g] (K x N) of G groups, the bias
added in the forward), counted since the process started, over the train
iterations since then (`ctx["iterations"]`: the DQN family's
`dqn/iterations` counter, as `host_syncs_per_iter` reads it; for the
actor-critic family, which counts none, the iterations the harness ran). A product's least
time is the larger of its operations at the tensor cores' 3xTF32 rate (3 *
2GRKN over the TF32 peak) and its f32 bytes, x and B read once and y written
once with the bias (4G(RK + KN + RN + N)), at the HBM rate, whichever kernel
variant forms the product. A run without a trace, peaks, the counter
registry or a kernel-routed product reads nothing."""

NAME = "linear_mm_roofline"
UNIT = "%"
LAYER = "kernels"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"
KERNELS = "grouped_mm"
COUNTERS = ("linear/fwd", "linear/dx")


def least_seconds(G: int, R: int, K: int, N: int, peaks: dict) -> float:
    """The least time of one product on the card of `peaks`."""
    t_ops = 3 * 2.0 * G * R * K * N / peaks["tf32_flops"]
    t_bytes = 4.0 * G * (R * K + K * N + R * N + N) / peaks["hbm_bytes_per_s"]
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
                if isinstance(key, tuple) and len(key) == 3 and key[0] in COUNTERS and key[1] == "kernel") / iters
    device_s = sum(us for name, (_, us) in t["by_name"].items() if KERNELS in name) / 1e6
    if not least or not device_s:
        return None
    return 100.0 * least / device_s
