"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Phases, each printing one JSON line; any failure propagates and the script
exits non-zero:

1. device  — requires CUDA; prints the card's name and, on a line of its own,
             `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`.
2. build   — builds the GRU kernels from `codebase_tpu_torch/csrc/` with nvcc.
3. kernels — holds each kernel against its plain PyTorch version at the
             rollout shape (a) G=2 T=1 B=65536, the update shape (b) G=2 T=26
             B=1024, a ragged shape (c) G=3 T=7 B=1000, the QMIX update
             and rollout shapes (d) G=3 T=26 B=512 and (e) G=3 T=1 B=32768,
             the actor-critic update and rollout shapes (f) G=2 T=25
             B=8192 and (g) G=2 T=1 B=8192, the SMAClite 3m shapes:
             QMIX's rollout (h) G=3 T=1 B=65536 and update (i) G=3 T=61
             B=256, MAPPO's update (j) G=3 T=60 B=8192, rollout (k) G=3
             T=1 B=8192 and target critic (l) G=3 T=61 B=8192, LBF
             MAPPO's target critic (m) G=2 T=26 B=8192, and the evals of
             100 episodes (n) G=3 T=1 B=100 and (o) G=2 T=1 B=100 (H=128),
             and for the wide kernels (H >= 256) the MMM2 shapes at H=512
             G=10: QMIX's rollout (p) T=1 B=2048, update (q) T=121 B=256
             and eval (r) T=1 B=100, MAPPO's rollout (s) T=1 B=256, update
             (t) T=120 B=256 and target critic (u) T=121 B=256, and two
             ragged shapes (v) G=3 T=7 B=1000 H=256, (w) G=3 T=5 B=333
             H=384 (every shape a train phase below gives the kernels): the
             forward against `gru_sequence_plain`, the whole backward (recurrence, weight
             gradient, reduction) against `gru_backward_plain`, the weight
             gradient alone against `gru_dw_plain` on the recurrence
             kernel's outputs; checks that two backward calls, and two
             reductions, are bitwise equal; and times each kernel, its plain
             version and a PyTorch yardstick (`torch.nn.GRUCell` at T=1,
             else `torch.nn.GRU` (cuDNN) for the forward, cuDNN forward +
             backward for the backward, `torch.bmm` for the weight gradient,
             `torch.sum` for the reduction) on the device (see `time_ms`; the
             reduction's input fits in the L2, so it is timed on copies that
             do not, see `cold_copies`).
Then twelve train phases through `codebase_tpu_torch.run.main`, each with
the launch counters set to 0 just before and read just after, and logging
every iteration (`log_interval` = E*T, so the host loop's chunk is one
iteration, as before the chunk rule):
4. train       — recurrent IDQN on lbforaging:Foraging-8x8-2p-3f-v3 (T=25,
                 layers [128,128], 65536 envs, batch 1024, 8 updates per
                 collect), 3 iterations and one eval: the GRU kernels at (a),
                 (b) and (o).
5. train_qmix  — the QMIX preset (CooperativeReward) with reward
                 standardisation, the recurrent critic shared by the 3 agents
                 of lbforaging:Foraging-10x10-3p-3f-v3 (the kernels at G=3),
                 32768 envs, batch 512, 3 iterations and one eval: (e), (d)
                 and (n).
6. train_vdn   — the VDN preset at the JAX package's `vdn_shared_lbf10`
                 sizes (MLP, shared, 32768 envs, batch 512), 2 iterations,
                 no GRU launch.
7. train_lstm  — recurrent IDQN with the LSTM cell and return
                 standardisation on Foraging-8x8-2p-3f-v3 (16384 envs, batch
                 1024), 2 iterations, no GRU launch.
8. train_mappo — the MAPPO preset with a recurrent actor and a recurrent
                 centralised critic on Foraging-8x8-2p-3f-v3, 8192 envs (the
                 JAX package's `ia2c_lbf` lane width), 3 iterations: the GRU
                 kernels at (g) in the rollout, (f) in the update and (m) for
                 the target critic (35 forward and 8 of each backward kernel
                 per iteration); the target critic follows the refresh rule.
9. train_ia2c  — the `ia2c_lbf` lane as the JAX package defines it (MLP,
                 8192 envs), 2 iterations, no GRU launch.
10. train_ippo_std — IPPO (MLP, 8192 envs) with reward and return
                 standardisation, 2 iterations: the reward streams and the
                 return moments advance on the card.
11. train_qmix_smaclite — the JAX package's `qmix_smaclite_3m` lane
                 (smaclite:3m-v0, T=60, 65536 envs, batch 256, buffer 65536)
                 with the recurrent critic (layers [128,128], no sharing):
                 the GRU kernels at (h), (i) and (n), 76 forwards and 8 of each
                 backward kernel per iteration; at least 3 iterations (the
                 episodes end early, so the env steps of 2 full-length
                 iterations take more) and one eval.
12. train_mappo_smaclite — MAPPO on smaclite:3m-v0, T=60, recurrent actor
                 and centralised recurrent critic, 8192 envs: the GRU at (k)
                 in the rollout, (j) in the update and (l) for the target
                 critic; 70 forwards and 8 of each backward kernel per
                 iteration.
13. train_qmix_rware — the JAX package's `qmix_rware` lane
                 (rware-tiny-2ag-v2, T=500, MLP, 8192 envs, batch 128,
                 buffer 16384, bf16 replay), 2 iterations, no GRU launch.
14. train_qmix_mmm2 — the JAX package's `qmix_smaclite_mmm2_big` lane
                 (smaclite:MMM2-v0, T=120, the 10 allies' shared 2x512 GRU
                 critic in bf16, 2048 envs, batch 256, buffer 2048, early
                 exit on under auto): the wide kernels at (p), (q) and (r).
15. train_mappo_mmm2 — `mappo_smaclite_mmm2_big` (shared 2x512 GRU actor
                 and centralised critic in bf16, 256 envs, no early exit):
                 the wide kernels at (s), (t) and (u).
The SMAClite 3m and MMM2 QMIX phases are followed by rollouts of their
trained policy with the early exit on and off in turns, which must be
identical (and leave the caller's generator alike), timed on the host.
The SMAClite phases count, on the card, the actions their rollouts took
that the step's mask forbade (it must be 0), the valid actions per step,
the mean episode length, the steps the last rollout took and whether the
early exit was on, and check that QMIX's replay stores f32 obs and
the masks. Then the kernel summary line and, last, the device line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import itertools
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a CUDA GPU")

from codebase_tpu_torch import run as port_run  # noqa: E402
from codebase_tpu_torch.algos import ac as port_ac  # noqa: E402
from codebase_tpu_torch.algos import dqn as port_dqn  # noqa: E402
from codebase_tpu_torch.config import load_config  # noqa: E402
from codebase_tpu_torch.envs import vector as port_vector  # noqa: E402
from codebase_tpu_torch.ops import fused_gru as fg  # noqa: E402
from codebase_tpu_torch.utils.device import resolve_device  # noqa: E402

SHAPES = {
    "a": dict(G=2, T=1, B=65536, role="rollout: policy step, T=1 over all envs"),
    "b": dict(G=2, T=26, B=1024, role="update: online/target nets over T+1=26 steps"),
    "c": dict(G=3, T=7, B=1000, role="ragged: B not a multiple of any tile"),
    "d": dict(G=3, T=26, B=512, role="QMIX update: the critic shared by N=3 agents over T+1=26 steps"),
    "e": dict(G=3, T=1, B=32768, role="QMIX rollout: policy step of the shared critic, T=1 over all envs"),
    "f": dict(G=2, T=25, B=8192, role="actor-critic update: actor and critic over the whole rollout, T=25"),
    "g": dict(G=2, T=1, B=8192, role="actor-critic rollout: the actor's policy step, T=1 over all envs"),
    "h": dict(G=3, T=1, B=65536, role="SMAClite 3m QMIX rollout: the 3 agents' critics, T=1 over all envs"),
    "i": dict(G=3, T=61, B=256, role="SMAClite 3m QMIX update: online/target critics over T+1=61 steps"),
    "j": dict(G=3, T=60, B=8192, role="SMAClite 3m MAPPO update: actor and critic over the whole rollout, T=60"),
    "k": dict(G=3, T=1, B=8192, role="SMAClite 3m MAPPO rollout: the actor's policy step, T=1 over all envs"),
    "l": dict(G=3, T=61, B=8192, role="SMAClite 3m MAPPO target critic: bootstrap values over T+1=61 steps"),
    "m": dict(G=2, T=26, B=8192, role="LBF MAPPO target critic: bootstrap values over T+1=26 steps"),
    "n": dict(G=3, T=1, B=100, role="QMIX eval (LBF and SMAClite): policy step over 100 episodes"),
    "o": dict(G=2, T=1, B=100, role="IDQN eval: policy step over 100 episodes"),
    # the wide kernels (H >= 256): the MMM2 lanes' shared 2x512 GRU gathered
    # for the 10 allies (G=10), and two ragged shapes of other widths
    "p": dict(G=10, T=1, B=2048, H=512, role="MMM2 QMIX rollout: the shared critic, T=1 over all envs"),
    "q": dict(G=10, T=121, B=256, H=512, role="MMM2 QMIX update: online/target critics over T+1=121 steps"),
    "r": dict(G=10, T=1, B=100, H=512, role="MMM2 QMIX eval: policy step over 100 episodes"),
    "s": dict(G=10, T=1, B=256, H=512, role="MMM2 MAPPO rollout: the actor's policy step, T=1 over all envs"),
    "t": dict(G=10, T=120, B=256, H=512, role="MMM2 MAPPO update: actor and critic over the padded rollout, T=120"),
    "u": dict(G=10, T=121, B=256, H=512, role="MMM2 MAPPO target critic: bootstrap values over T+1=121 steps"),
    "v": dict(G=3, T=7, B=1000, H=256, role="ragged at H=256"),
    "w": dict(G=3, T=5, B=333, H=384, role="ragged at H=384"),
}
for _shape in SHAPES.values():
    _shape.setdefault("H", 128)
# the value-based phases' replay settings
DQN_ARGV = ["algorithm.updates_per_collect=8", "algorithm.training_start=0", "algorithm.replay_slot_reuse=clear"]
# published peaks, dense, no sparsity (NVIDIA data sheets): HBM bytes/s,
# FP32 (non-tensor-core) flop/s and TF32 tensor-core flop/s, keyed by the
# name the card reports
PEAKS = {
    "H100 80GB HBM3": (3.35e12, 67e12, 495e12),  # SXM
    "H100 PCIe": (2.0e12, 51e12, 378e12),
}
# cycles of the spin kernel that holds the stream while a timed run of calls
# is enqueued (about 2 ms on an H100)
SPIN_CYCLES = 4_000_000
TOL = {
    # forward outputs are O(1) (tanh-bounded); only rounding order differs
    "y": (1e-5, 1e-5),
    "hT": (1e-5, 1e-5),
    # per-row gradients: one matmul reduction order differs per step
    "dgi": (1e-5, 1e-5),
    "dh0": (1e-5, 1e-5),
    # sums over T*B terms in another order: 1e-4 relative to the largest entry
    "dW_hh": (1e-4, "1e-4*max|ref|"),
    "db_hh": (1e-4, "1e-4*max|ref|"),
    "partials_sum": (1e-5, "1e-5*max|ref|"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def compare(name, got, ref) -> float:
    rtol, atol = TOL[name]
    if isinstance(atol, str):
        atol = float(atol.split("*")[0]) * ref.abs().max().item()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{name}: max_abs_err {err.max().item():.3e} over tolerance rtol={rtol} atol={atol:.3e}"
        )
    return err.max().item()


def _run_ms(fn, n) -> float:
    """ms per call of n back-to-back calls between two CUDA events. A spin
    kernel holds the stream while the host enqueues them, so the device runs
    them back to back: neither the wrapper's host time nor a launch gap is
    counted, unless the host takes longer than the spin."""
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n


def cold_copies(t, factor=4) -> list:
    """`t` and copies of it, together at least `factor` times the card's L2.
    A run of calls that takes them in turn reads each from HBM: between two
    reads of one copy the others have gone through the L2. A kernel whose
    input fits in the L2 is timed so, to be held to its HBM bound."""
    l2 = torch.cuda.get_device_properties(t.device).L2_cache_size
    return [t] + [t.clone() for _ in range(max(1, -(-factor * l2 // t.nbytes) - 1))]


def time_ms(fn, reps=25, warmup=3) -> float:
    """Device time of one call (ms): the median over `reps` runs of n calls,
    n (1 to 20) chosen so that a run fills about 1 ms. A call whose host time
    outlasts the spin (the plain versions, which launch hundreds of small
    kernels) is timed with its host gaps."""
    for _ in range(warmup):
        fn()
    n = max(1, min(20, int(1.0 / max(_run_ms(fn, 1), 1e-3))))
    return statistics.median(_run_ms(fn, n) for _ in range(reps))


def bounds(kernel, G, T, B, H, P, peaks):
    """Least time (ms) for the function's work: max(bytes / HBM rate,
    operations / peak rate), each input read once and each output written
    once, no scratch or partials. The forward's product, the backward's
    three (h_prev @ W_hh, dgh @ W_hh^T, h_prev^T dgh), of which the
    recurrence alone runs the first two, and the weight gradient's one run
    on tensor cores in 3xTF32 (three TF32 products each); the reduction's
    adds on FP32 CUDA cores."""
    bw, fp32, tf32 = peaks
    H3 = 3 * H
    K = T * B
    if kernel == "gru_fwd":
        nbytes = 4 * G * (K * H3 + H * H3 + H3 + B * H + K * H + B * H)
        t_ops = 3 * 2 * G * K * H * H3 / tf32
    elif kernel == "gru_bwd":  # the whole backward: gi, W, b, h0, y, dy, dhT -> dgi, dW, db, dh0
        ins = K * H3 + H * H3 + H3 + B * H + 2 * K * H + B * H
        outs = K * H3 + H * H3 + H3 + B * H
        nbytes = 4 * G * (ins + outs)
        t_ops = 3 * 3 * 2 * G * K * H * H3 / tf32
    elif kernel == "gru_bwd_recurrence":  # gi, W, b, h0, y, dy, dhT -> dgi, dh0, dgh_n
        ins = K * H3 + H * H3 + H3 + B * H + 2 * K * H + B * H
        outs = K * H3 + B * H + K * H
        nbytes = 4 * G * (ins + outs)
        t_ops = 3 * 2 * 2 * G * K * H * H3 / tf32
    elif kernel == "gru_dw":  # h_prev, dgh -> dW, db
        nbytes = 4 * G * (K * H + K * H3 + H * H3 + H3)
        t_ops = 3 * 2 * G * K * H * H3 / tf32
    else:  # gru_reduce
        nbytes = 4 * G * (P + 1) * (H * H3 + H3)
        t_ops = G * (P - 1) * (H * H3 + H3) / fp32
    t_bytes, t_ops = nbytes / bw * 1e3, t_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_shape(key, G, T, B, H, gen, peaks):
    dev = torch.device("cuda")
    gi = torch.randn((G, T, B, 3 * H), device=dev, generator=gen)
    # scaled so that h @ W_hh has the same spread at every H as at H=128
    w = torch.randn((G, H, 3 * H), device=dev, generator=gen) * (0.1 * (128 / H) ** 0.5)
    b = torch.randn((G, 3 * H), device=dev, generator=gen) * 0.1
    h0 = torch.randn((G, B, H), device=dev, generator=gen)
    ky = torch.randn((G, T, B, H), device=dev, generator=gen)
    kh = torch.randn((G, B, H), device=dev, generator=gen)

    with torch.no_grad():
        y, hT = fg.gru_fwd_cuda(gi, w, b, h0)
        yr, hTr = fg.gru_sequence_plain(gi, w, b, h0)
        errs = {"y": compare("y", y, yr), "hT": compare("hT", hT, hTr)}
        # the whole backward (recurrence, weight gradient, reduction) and
        # its plain version on the same inputs; two calls bitwise equal
        grads = fg.gru_backward_cuda(gi, w, b, h0, y, ky, kh)
        again = fg.gru_backward_cuda(gi, w, b, h0, y, ky, kh)
        rgrads = fg.gru_backward_plain(gi, w, b, h0, y, ky, kh)
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(grads, again)):
            raise AssertionError("gru_backward: two calls on the same inputs differ")
        for n, g_, r_ in zip(("dgi", "dW_hh", "db_hh", "dh0"), grads, rgrads):
            errs[n] = compare(n, g_, r_)
        del again, rgrads
        # the weight gradient alone, on the recurrence kernel's dgi and dgh_n
        dgi, _, dgh_n = fg.gru_bwd_cuda(gi, w, b, h0, y, ky, kh)
        partials = fg.gru_dw_cuda(h0, y, dgi, dgh_n)
        sums = fg.reduce_partials_cuda(partials)
        dw_ref, db_ref = fg.gru_dw_plain(h0, y, dgi, dgh_n)
        errs["dw_dW_hh"] = compare("dW_hh", sums[:, : H * 3 * H].reshape(w.shape), dw_ref)
        errs["dw_db_hh"] = compare("db_hh", sums[:, H * 3 * H :], db_ref)
        if not torch.equal(sums, fg.reduce_partials_cuda(partials)):
            raise AssertionError("gru_reduce: two calls on the same partials differ")
        errs["partials_sum"] = compare("partials_sum", sums, fg.reduce_partials_plain(partials))
        P = partials.shape[1]
        # the library's product: f32 (allow_tf32 False) on h_prev and dgh
        # assembled beforehand, so it is timed without the concatenations
        hp_t = torch.cat([h0[:, None], y[:, :-1]], 1).reshape(G, T * B, H).transpose(1, 2)
        dgh = torch.cat([dgi[..., : 2 * H], dgh_n], -1).reshape(G, T * B, 3 * H)
        ring = itertools.cycle(cold_copies(partials))
        t = {
            "gru_fwd": time_ms(lambda: fg.gru_fwd_cuda(gi, w, b, h0)),
            "gru_fwd_plain": time_ms(lambda: fg.gru_sequence_plain(gi, w, b, h0)),
            "gru_bwd": time_ms(lambda: fg.gru_backward_cuda(gi, w, b, h0, y, ky, kh)),
            "gru_bwd_recurrence": time_ms(lambda: fg.gru_bwd_cuda(gi, w, b, h0, y, ky, kh)),
            "gru_bwd_recurrence_plain": time_ms(lambda: fg.gru_bwd_plain(gi, w, b, h0, y, ky, kh)),
            "gru_bwd_plain": time_ms(lambda: fg.gru_backward_plain(gi, w, b, h0, y, ky, kh)),
            "gru_dw": time_ms(lambda: fg.gru_dw_cuda(h0, y, dgi, dgh_n)),
            "gru_dw_plain": time_ms(lambda: fg.gru_dw_plain(h0, y, dgi, dgh_n)),
            "gru_dw_library": time_ms(lambda: torch.bmm(hp_t, dgh)),
            "gru_reduce": time_ms(lambda: fg.reduce_partials_cuda(next(ring))),
            "gru_reduce_plain": time_ms(lambda: fg.reduce_partials_plain(next(ring))),
            "gru_reduce_library": time_ms(lambda: torch.sum(next(ring), 1)),
        }
        del ring, hp_t, dgh
    # yardsticks, one call per group, input projection included (so each is
    # an upper bound on the recurrence alone): at T=1 torch.nn.GRUCell (two
    # f32 GEMMs and a fused gate kernel), else cuDNN's GRU
    cudnn = [torch.nn.GRU(H, H).to(dev) for _ in range(G)]
    x = torch.randn((T, B, H), device=dev, generator=gen)
    h0c = h0[:, None]  # (G, 1, B, H)
    with torch.no_grad():
        if T == 1:
            cells = [torch.nn.GRUCell(H, H).to(dev) for _ in range(G)]
            t["gru_fwd_library"] = time_ms(lambda: [c(x[0], h0[g]) for g, c in enumerate(cells)])
            library = "torch.nn.GRUCell, one call per group, input projection included"
        else:
            t["gru_fwd_library"] = time_ms(lambda: [m(x, h0c[g]) for g, m in enumerate(cudnn)])
            library = "torch.nn.GRU (cuDNN), one call per group, input projection included"
    xg = x.clone().requires_grad_()

    def lib_fwd_bwd():
        outs = [m(xg, h0c[g]) for g, m in enumerate(cudnn)]
        torch.autograd.backward([o[0].sum() for o in outs])

    t["gru_bwd_library"] = time_ms(lib_fwd_bwd)
    del cudnn
    libraries = {
        "gru_fwd": library,
        "gru_bwd": "torch.nn.GRU (cuDNN) forward + backward, one call per group",
        "gru_dw": "torch.bmm(h_prev^T, dgh), f32 (allow_tf32 False), inputs assembled beforehand",
        "gru_reduce": "torch.sum(partials, 1)",
    }
    names = {"gru_fwd": ("y", "hT"), "gru_bwd": ("dgi", "dW_hh", "db_hh", "dh0"),
             "gru_dw": ("dw_dW_hh", "dw_db_hh"), "gru_reduce": ("partials_sum",)}
    out = {}
    for k in ("gru_fwd", "gru_bwd", "gru_dw", "gru_reduce"):
        bound_ms, bound_by = bounds(k, G, T, B, H, P, peaks)
        out[k] = {
            "max_abs_err": max(errs[n] for n in names[k]),
            "errors": {n: errs[n] for n in names[k]},
            "tolerance": {n: list(TOL[n.removeprefix("dw_")]) for n in names[k]},
            "ms": t[k],
            "plain_ms": t[k + "_plain"],
            "library_ms": t[k + "_library"],
            "library": libraries[k],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
    out["gru_bwd"]["recurrence_ms"] = t["gru_bwd_recurrence"]
    out["gru_bwd"]["recurrence_plain_ms"] = t["gru_bwd_recurrence_plain"]
    out["gru_bwd"]["recurrence_bound_ms"], out["gru_bwd"]["recurrence_bound_by"] = bounds(
        "gru_bwd_recurrence", G, T, B, H, P, peaks)
    out["gru_reduce"]["partials_per_group"] = P
    return out


def train_phase(phase, smi, argv, E, iters, per_iteration, T=25):
    """Train through `codebase_tpu_torch.run.main` on the card for at least
    `iters` iterations of E envs (exactly `iters` when every episode runs
    the full T), logging every iteration, and (for the value-based family)
    one eval at the end, with the launch counters set to 0 just before and
    read just after. Fails unless every logged loss and every parameter is
    finite and each GRU kernel named in `per_iteration` launched at least
    that often per iteration (and the others never). Returns (launch
    counts, final state)."""
    with tempfile.TemporaryDirectory() as run_dir:
        argv = argv + [
            f"env.time_limit={T}",
            f"env.parallel_envs={E}",
            # the loop stops once env steps exceed total_steps: `iters`
            # iterations of (at most) E*T steps each; log_interval = E*T
            # makes the host loop's chunk one iteration
            f"algorithm.total_steps={(iters - 1) * E * T}",
            f"algorithm.eval_interval={(iters - 1) * E * T}",
            f"algorithm.log_interval={E * T}",
            "seed=0",
            "device=cuda",
            f"run_dir={run_dir}",
        ]
        torch.cuda.reset_peak_memory_stats()
        fg.reset_launch_counts()
        rows, state = port_run.main(argv)
        counts = fg.launch_counts()
        torch.cuda.synchronize()
    ran = len(state.timings)
    if ran < iters:
        raise AssertionError(f"{phase}: expected at least {iters} train iterations, ran {ran}")
    if not rows:
        raise AssertionError(f"{phase}: results.csv was not written")
    losses = [float(r["loss"]) for r in rows if r.get("loss")]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{phase}: losses not finite: {losses}")
    if not all(torch.isfinite(p).all() for p in state.model.param_leaves()):
        raise AssertionError(f"{phase}: parameters not finite after training")
    for k, v in counts.items():
        if v < per_iteration.get(k, 0) * ran or (k not in per_iteration and v):
            raise AssertionError(f"{phase}: launches {counts} over {ran} iterations; expected {per_iteration}")
    steady = state.timings[1:]
    emit({
        "phase": phase, "card": smi, "argv": argv[:-1],
        "iterations": ran, "env_steps": state.env_steps, "updates": state.updates,
        "launches": counts,
        "launches_per_iteration_with_eval": {k: v / ran for k, v in counts.items()},
        "iteration_seconds": [s for _, s in state.timings],
        "env_steps_per_s_each": [n / s for n, s in state.timings],
        "env_steps_per_s_after_first": sum(n for n, _ in steady) / sum(s for _, s in steady),
        "loss": losses,
        "results_columns": list(rows[0].keys()),
        "peak_device_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        # how each network's recurrent layers ran (`RNNSpec.route`)
        "gru_route": {n: getattr(m.spec, "route", "mlp") for n, m in state.model.named_children() if hasattr(m, "spec")},
    })
    return counts, state


class MaskAudit:
    """Wraps the episode collector in the train modules: for every rollout,
    counts on the card the actions taken on filled steps that the mask of
    their step forbade, the valid actions per agent and filled step, and
    the mean episode length. `report()` holds the last rollout of `n_envs`
    envs (the training one) and the invalid count over every rollout. The
    audit runs inside the timed train iteration; the QMIX phase times it
    apart (`audit_ms`)."""

    def __init__(self, modules, n_envs):
        self.modules, self.n_envs, self.calls = modules, n_envs, []

    def __enter__(self):
        self.collect = self.modules[0].collect_episodes
        for m in self.modules:
            m.collect_episodes = self
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m.collect_episodes = self.collect

    def __call__(self, env, policy, carry, generator, n_envs, *args, **kwargs):
        steps = []

        def counted(*a):
            steps.append(1)
            return policy(*a)

        rollout, carry = self.collect(env, counted, carry, generator, n_envs, *args, **kwargs)
        audit = audit_rollout(rollout.action_mask, rollout.actions, rollout.filled)
        audit["policy_steps"] = len(steps)  # T, or fewer where the early exit stopped
        opt = kwargs.get("early_exit", args[2] if len(args) > 2 else "auto")
        audit["early_exit_on"] = (n_envs >= 512 and env.early_termination_possible) if opt == "auto" else bool(opt)
        self.calls.append((n_envs, audit))
        return rollout, carry

    def report(self) -> dict:
        trained = [a for n, a in self.calls if n == self.n_envs]
        if not trained:  # the train modules no longer reach the collector through the wrapped name
            raise AssertionError(f"MaskAudit saw no rollout of {self.n_envs} envs ({len(self.calls)} in all)")
        last = trained[-1]
        return {**{k: float(v) for k, v in last.items()}, "rollouts": len(self.calls),
                "invalid_all_rollouts": int(sum(a["invalid"] for _, a in self.calls))}


def audit_rollout(mask, actions, filled) -> dict:
    """mask (T+1, E, N, A), actions (T, E, N), filled (T, E), time-major:
    each action against the mask of the observation it was taken from."""
    taken = mask[:-1].gather(-1, actions.unsqueeze(-1)).squeeze(-1)  # (T, E, N)
    cells = (filled > 0)[..., None].expand_as(taken)
    return {"invalid": ((taken == 0) & cells).sum(), "agent_steps": cells.sum(),
            "valid_actions_per_step": (mask[:-1].sum(-1) * cells).sum() / cells.sum(),
            "mean_episode_length": filled.sum(0).mean()}


def smaclite_phase(phase, smi, argv, E, iters, per_iteration, modules, T=60):
    """A train phase on SMAClite under a `MaskAudit`: fails if any action
    of any rollout left its mask. `policy_steps` is the number of steps the
    last training rollout took: T, or fewer under the early exit."""
    with MaskAudit(modules, E) as audit:
        counts, state = train_phase(phase, smi, argv, E=E, iters=iters, per_iteration=per_iteration, T=T)
    report = audit.report()
    if report["invalid"] or report["invalid_all_rollouts"]:
        raise AssertionError(f"{phase}: actions outside the mask: {report}")
    emit({"phase": f"{phase}_masks", **report})
    return counts, state


def early_exit_cost(phase, smi, argv, E, T, state) -> None:
    """Rollouts of the phase's trained QMIX policy (epsilon 0.05) with the
    early exit on and off, in turns (on, off, on, off), each from a caller's
    generator seeded alike: fails unless the rollouts and the caller's next
    draw are identical. Reports each rollout's host-clock seconds (ending
    in a device sync) and steps, and the time a step took with and without
    the per-step `any(running)` sync."""
    env, _ = port_run.build_envs(load_config(argv + [f"env.time_limit={T}", f"env.parallel_envs={E}"]))
    policy = state.model.policy(0.05)
    seconds, runs = {True: [], False: []}, {}
    for early in (True, False, True, False):
        gen = torch.Generator(device="cuda").manual_seed(7)
        steps = []

        def counted(*a):
            steps.append(1)
            return policy(*a)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout, _ = port_vector.collect_episodes(env, counted, state.model.critic.init_hiddens(E), gen, E, T,
                                                  early_exit=early)
        torch.cuda.synchronize()
        seconds[early].append(time.perf_counter() - t0)
        runs[early] = (rollout, torch.rand((4,), generator=gen, device="cuda"), len(steps))
    (on, next_on, steps_on), (off, next_off, steps_off) = runs[True], runs[False]
    same = [f for f in ("obs", "actions", "rewards", "stat_rewards", "dones", "filled", "action_mask")
            if torch.equal(getattr(on, f), getattr(off, f))]
    if len(same) != 7 or not torch.equal(next_on, next_off) or steps_off != T:
        raise AssertionError(f"{phase}: early exit on/off differ: equal fields {same}, next draw equal "
                             f"{torch.equal(next_on, next_off)}, steps {steps_on} / {steps_off}")
    emit({"phase": phase, "card": smi, "envs": E, "time_limit": T, "steps_on": steps_on, "steps_off": steps_off,
          "seconds_on": seconds[True], "seconds_off": seconds[False],
          "ms_per_step_on": [1e3 * t / steps_on for t in seconds[True]],
          "ms_per_step_off": [1e3 * t / steps_off for t in seconds[False]],
          "identical_rollouts_and_next_draw": True})


def mmm2_report(state, nets) -> None:
    """Fails unless every GRU network of an MMM2 phase holds the 10 allies'
    shared weights in bf16 on the wide kernels' route."""
    got = [(n.n_agents, n.n_groups, n.spec.hidden_size, n.spec.compute_dtype, n.spec.route) for n in nets]
    if any(g != (10, 1, 512, "bfloat16", "kernel_wide") for g in got):
        raise AssertionError(f"MMM2 networks (agents, groups, H, dtype, route): {got}")
    emit({"phase": "mmm2_networks", "agents_groups_hidden_dtype_route": got})


def check_target_refresh(state, tau=200) -> None:
    """The MAPPO target critic after the run: it holds the critic's params
    exactly when the last iteration began at an env-step count that is a
    multiple of tau (the reference's rule, tested before the count
    advances); every iteration of 8192 envs x t_max 25 steps begins at a
    multiple of 204,800, so then it is refreshed every iteration."""
    start = state.env_steps - state.timings[-1][0]
    target, critic = state.target_critic.param_leaves(), state.model.critic.param_leaves()
    same = all(torch.equal(t, c) for t, c in zip(target, critic))
    if same != (start % tau == 0) or not all(torch.isfinite(t).all() for t in target):
        raise AssertionError(f"train_mappo: target critic equal to the critic: {same}; last iteration began at "
                             f"{start} env steps (tau {tau})")
    emit({"phase": "train_mappo_target", "last_iteration_start": start, "target_equals_critic": same,
          "steps_per_iteration": [n for n, _ in state.timings]})


def main() -> None:
    # --- 1. device
    dev = resolve_device("cuda")  # also pins f32 matmuls (allow_tf32 = False)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    peaks = next((v for k, v in PEAKS.items() if k in name), PEAKS["H100 80GB HBM3"])
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "peaks": {"hbm_bytes_per_s": peaks[0], "fp32_flops": peaks[1], "tf32_flops": peaks[2]},
          "peaks_for": next((k for k in PEAKS if k in name), "H100 80GB HBM3 (assumed)")})

    # --- 2. build
    t0 = time.perf_counter()
    lib_path = fg.build_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib_path.name,
          "nvcc_flags": fg.NVCC_FLAGS})

    # --- 3. kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for key, s in SHAPES.items():
        results[key] = check_shape(key, s["G"], s["T"], s["B"], s["H"], gen, peaks)
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "card": smi,
          "shapes": SHAPES, "results": results})

    # --- 4. train: recurrent IDQN
    counts, _ = train_phase("train", smi, [
        "+algorithm=idqn", "env.name=lbforaging:Foraging-8x8-2p-3f-v3", "algorithm.model.use_rnn=true",
        "algorithm.model.layers=[128,128]", "algorithm.batch_size=1024", "algorithm.buffer_size=131072",
        *DQN_ARGV,
    ], E=65536, iters=3, per_iteration={"fwd": 25, "bwd": 8, "dw": 8, "reduce": 8})

    # --- 5. train_qmix: the QMIX preset, shared recurrent critic (G=3),
    # reward standardisation on the card
    qmix_counts, state = train_phase("train_qmix", smi, [
        "+algorithm=qmix", "env.name=lbforaging:Foraging-10x10-3p-3f-v3", "algorithm.model.use_rnn=true",
        "algorithm.model.layers=[128,128]", "algorithm.model.parameter_sharing=true",
        "algorithm.batch_size=512", "algorithm.buffer_size=65536", "env.standardise_rewards=true",
        *DQN_ARGV,
    ], E=32768, iters=3, per_iteration={"fwd": 41, "bwd": 8, "dw": 8, "reduce": 8})
    stream_n = state.reward_stream.n
    if not float(stream_n.min()) > 0 or state.reward_stream.wmean.device.type != "cuda":
        raise AssertionError("train_qmix: the reward stream did not advance on the card")
    emit({"phase": "train_qmix_reward_stream", "n_min": float(stream_n.min()), "n_mean": float(stream_n.mean()),
          "wmean_mean": float(state.reward_stream.wmean.mean())})
    del state

    # --- 6. train_vdn: the vdn_shared_lbf10 lane (MLP): no GRU launch
    train_phase("train_vdn", smi, [
        "+algorithm=vdn", "env.name=lbforaging:Foraging-10x10-3p-3f-v3", "algorithm.model.parameter_sharing=true",
        "algorithm.batch_size=512", "algorithm.buffer_size=65536", *DQN_ARGV,
    ], E=32768, iters=2, per_iteration={})

    # --- 7. train_lstm: the LSTM never reaches the GRU kernels; return
    # standardisation (per agent) on the card
    _, state = train_phase("train_lstm", smi, [
        "+algorithm=idqn", "env.name=lbforaging:Foraging-8x8-2p-3f-v3", "algorithm.model.use_rnn=lstm",
        "algorithm.model.layers=[128,128]", "algorithm.batch_size=1024", "algorithm.buffer_size=32768",
        "algorithm.standardise_returns=true", *DQN_ARGV,
    ], E=16384, iters=2, per_iteration={})
    rms = state.ret_rms
    if not (float(rms.count) > 1e-4 and torch.isfinite(rms.mean).all() and torch.isfinite(rms.var).all()):
        raise AssertionError(f"train_lstm: return moments did not advance or are not finite: {rms}")
    emit({"phase": "train_lstm_return_moments", "count": float(rms.count), "mean": rms.mean.tolist(),
          "var": rms.var.tolist()})
    del state

    # --- 8. train_mappo: recurrent actor and centralised recurrent critic,
    # the GRU kernels at (g) in the rollout and (f) in the update
    mappo_counts, state = train_phase("train_mappo", smi, [
        "+algorithm=mappo", "env.name=lbforaging:Foraging-8x8-2p-3f-v3",
        "algorithm.model.actor.use_rnn=true", "algorithm.model.critic.use_rnn=true",
    ], E=8192, iters=3, per_iteration={"fwd": 35, "bwd": 8, "dw": 8, "reduce": 8})
    check_target_refresh(state)
    del state

    # --- 9. train_ia2c: the ia2c_lbf lane (MLP): no GRU launch
    train_phase("train_ia2c", smi, ["+algorithm=ia2c", "env.name=lbforaging:Foraging-8x8-2p-3f-v3"],
                E=8192, iters=2, per_iteration={})

    # --- 10. train_ippo_std: reward and return standardisation on the card
    _, state = train_phase("train_ippo_std", smi, [
        "+algorithm=ippo", "env.name=lbforaging:Foraging-8x8-2p-3f-v3", "env.standardise_rewards=true",
        "algorithm.standardise_returns=true",
    ], E=8192, iters=2, per_iteration={})
    stream, rms = state.reward_stream, state.ret_rms
    if not (float(stream.n.min()) > 0 and stream.wmean.device.type == "cuda" and torch.isfinite(stream.wmean).all()):
        raise AssertionError("train_ippo_std: the reward stream did not advance on the card")
    if not (float(rms.count) > 1e-4 and rms.mean.device.type == "cuda"
            and torch.isfinite(rms.mean).all() and torch.isfinite(rms.var).all()):
        raise AssertionError(f"train_ippo_std: return moments did not advance or are not finite: {rms}")
    emit({"phase": "train_ippo_std_moments", "stream_n_min": float(stream.n.min()),
          "stream_wmean_mean": float(stream.wmean.mean()), "returns_count": float(rms.count),
          "returns_mean": rms.mean.tolist(), "returns_var": rms.var.tolist()})
    del state

    # --- 11. train_qmix_smaclite: the qmix_smaclite_3m lane with the
    # recurrent critic, the GRU kernels at (h) and (i), masks everywhere
    # (16 forwards an iteration in the updates, and one a rollout step: the
    # early exit stops at the longest episode)
    smac3m_argv = ["+algorithm=qmix", "env.name=smaclite:3m-v0", "algorithm.model.use_rnn=true",
                   "algorithm.model.layers=[128,128]", "algorithm.batch_size=256", "algorithm.buffer_size=65536",
                   *DQN_ARGV]
    smac_qmix_counts, state = smaclite_phase("train_qmix_smaclite", smi, smac3m_argv, E=65536, iters=3,
                                             per_iteration={"fwd": 17, "bwd": 8, "dw": 8, "reduce": 8},
                                             modules=[port_dqn])
    buf = state.buffer
    if buf.obs.dtype != torch.float32 or buf.action_mask is None or buf.obs.device.type != "cuda":
        raise AssertionError(f"train_qmix_smaclite: replay obs {buf.obs.dtype}, masks stored: "
                             f"{buf.action_mask is not None}; expected float32 obs and masks on the card")
    # the buffer holds exactly the last rollout (buffer = envs, slots cleared)
    stored_rollout = (buf.action_mask.transpose(0, 1), buf.actions.transpose(0, 1), buf.filled.transpose(0, 1))
    stored = audit_rollout(*stored_rollout)
    if int(stored["invalid"]):
        raise AssertionError(f"train_qmix_smaclite: replay holds actions outside the mask: {stored}")
    emit({"phase": "train_qmix_smaclite_replay", "obs_dtype": str(buf.obs.dtype), "mask_dtype": str(buf.action_mask.dtype),
          "obs_gb": buf.obs.nbytes / 1e9, "mask_gb": buf.action_mask.nbytes / 1e9,
          **{k: float(v) for k, v in stored.items()},
          # device time of one audit of a 65536-env rollout, which each
          # timed iteration of the SMAClite phases includes
          "audit_ms": time_ms(lambda: audit_rollout(*stored_rollout))})
    del buf, stored_rollout
    early_exit_cost("early_exit_smaclite_3m", smi, smac3m_argv, 65536, 60, state)
    del state

    # --- 12. train_mappo_smaclite: recurrent actor and centralised
    # recurrent critic on 3m, the GRU kernels at (k), (j) and (l)
    smac_mappo_counts, state = smaclite_phase("train_mappo_smaclite", smi, [
        "+algorithm=mappo", "env.name=smaclite:3m-v0",
        "algorithm.model.actor.use_rnn=true", "algorithm.model.critic.use_rnn=true",
    ], E=8192, iters=2, per_iteration={"fwd": 11, "bwd": 8, "dw": 8, "reduce": 8}, modules=[port_ac])
    del state

    # --- 13. train_qmix_rware: the qmix_rware lane (MLP, bf16 replay)
    rware_counts, state = train_phase("train_qmix_rware", smi, [
        "+algorithm=qmix", "env.name=rware-tiny-2ag-v2", "algorithm.batch_size=128", "algorithm.buffer_size=16384",
        *DQN_ARGV,
    ], E=8192, iters=2, per_iteration={}, T=500)
    if state.buffer.obs.dtype != torch.bfloat16 or state.buffer.action_mask is not None:
        raise AssertionError("train_qmix_rware: expected bf16 replay obs and no masks")
    del state

    # --- 14. train_qmix_mmm2: the qmix_smaclite_mmm2_big lane (10 allies,
    # the shared 2x512 GRU critic in bf16): the wide kernels at (p), (q)
    # and (r); 2048 envs, so the early exit is on under auto
    mmm2_qmix_argv = [
        "+algorithm=qmix", "env.name=smaclite:MMM2-v0", "algorithm.model.use_rnn=true",
        "algorithm.model.layers=[512,512]", "algorithm.model.parameter_sharing=true",
        "algorithm.model.dtype=bfloat16", "algorithm.batch_size=256", "algorithm.buffer_size=2048", *DQN_ARGV,
    ]
    mmm2_qmix_counts, state = smaclite_phase("train_qmix_mmm2", smi, mmm2_qmix_argv, E=2048, iters=2,
                                             per_iteration={"fwd_wide": 17, "bwd_wide": 8, "dw": 8, "reduce": 8},
                                             modules=[port_dqn], T=120)
    mmm2_report(state, [state.model.critic])
    early_exit_cost("early_exit_mmm2", smi, mmm2_qmix_argv, 2048, 120, state)
    del state

    # --- 15. train_mappo_mmm2: the mappo_smaclite_mmm2_big lane (shared
    # 2x512 GRU actor and centralised critic in bf16, 256 envs: no early
    # exit): the wide kernels at (s), (t) and (u), 120 rollout steps and 10
    # forwards in the update an iteration
    mmm2_mappo_counts, state = smaclite_phase("train_mappo_mmm2", smi, [
        "+algorithm=mappo", "env.name=smaclite:MMM2-v0",
        *[f"algorithm.model.{part}.{k}" for part in ("actor", "critic") for k in (
            "use_rnn=true", "layers=[512,512]", "parameter_sharing=true", "dtype=bfloat16")],
    ], E=256, iters=2, per_iteration={"fwd_wide": 130, "bwd_wide": 8, "dw": 8, "reduce": 8},
        modules=[port_ac], T=120)
    mmm2_report(state, [state.model.actor, state.model.critic])
    del state

    sources = {
        "gru_fwd": "codebase_tpu/ops/fused_gru.py:80 (_fwd_kernel, pallas_call at :238)",
        "gru_bwd": "codebase_tpu/ops/fused_gru.py:105 (_bwd_kernel, pallas_call at :299)",
        "gru_dw": "codebase_tpu/ops/fused_gru.py:160 (_bwd_kernel's dW_hh/db_hh products, :160-165)",
        "gru_reduce": "codebase_tpu/ops/fused_gru.py:166 (_bwd_kernel's in-order dW_hh/db_hh sum, :166-167)",
    }
    roles = {"a": "rollout", "b": "update", "c": "ragged", "d": "qmix_update", "e": "qmix_rollout",
             "f": "ac_update", "g": "ac_rollout", "h": "smaclite_qmix_rollout", "i": "smaclite_qmix_update",
             "j": "smaclite_mappo_update", "k": "smaclite_mappo_rollout", "l": "smaclite_mappo_target",
             "m": "ac_target", "n": "qmix_eval", "o": "idqn_eval", "p": "mmm2_qmix_rollout",
             "q": "mmm2_qmix_update", "r": "mmm2_qmix_eval", "s": "mmm2_mappo_rollout", "t": "mmm2_mappo_update",
             "u": "mmm2_mappo_target", "v": "ragged_h256", "w": "ragged_h384"}
    resident = [k for k in SHAPES if SHAPES[k]["H"] == 128]
    wide = [k for k in SHAPES if SHAPES[k]["H"] != 128]
    phases = {"train": counts, "train_qmix": qmix_counts, "train_mappo": mappo_counts,
              "train_qmix_smaclite": smac_qmix_counts, "train_mappo_smaclite": smac_mappo_counts,
              "train_qmix_rware": rware_counts, "train_qmix_mmm2": mmm2_qmix_counts,
              "train_mappo_mmm2": mmm2_mappo_counts}
    summary = []
    # (name, counter, the kernel's key in the per-shape results, the shapes
    # it takes, the shape it is timed at and the phase its launches are from)
    for kernel, counter, k, keys, at, main_phase in (
            ("gru_fwd", "fwd", "gru_fwd", resident, "b", "train"),
            ("gru_bwd", "bwd", "gru_bwd", resident, "b", "train"),
            ("gru_fwd_wide", "fwd_wide", "gru_fwd", wide, "q", "train_qmix_mmm2"),
            ("gru_bwd_wide", "bwd_wide", "gru_bwd", wide, "q", "train_qmix_mmm2"),
            ("gru_dw", "dw", "gru_dw", list(SHAPES), "b", "train"),
            ("gru_reduce", "reduce", "gru_reduce", list(SHAPES), "b", "train")):
        r = results[at][k]
        entry = {
            "name": kernel,
            "route": "cuda",
            "source": "codebase_tpu_torch/csrc/fused_gru.cu",
            "replaces": sources[k],
            "launches": phases[main_phase][counter],
            "launches_from": main_phase,
            **{f"launches_{ph}": c[counter] for ph, c in phases.items()},
            "max_abs_err": max(results[s][k]["max_abs_err"] for s in keys),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library": r["library"],
            "timed_at": f"shape {at} (G={SHAPES[at]['G']} T={SHAPES[at]['T']} B={SHAPES[at]['B']} H={SHAPES[at]['H']})",
            **{f"{roles[key]}_shape_{key}": {f: results[key][k][f] for f in (
                "ms", "plain_ms", "library_ms", "library", "bound_ms", "bound_by")} for key in keys if key != at},
        }
        if k == "gru_bwd":
            entry["ms_is"] = "the whole backward: the recurrence kernel, gru_dw_kernel, gru_reduce_kernel"
            for f in ("recurrence_ms", "recurrence_plain_ms", "recurrence_bound_ms", "recurrence_bound_by"):
                entry[f] = r[f]
            entry["recurrence_library"] = (
                "none: no single PyTorch call computes the recurrence without the weight "
                "gradient (cuDNN's GRU backward forms dW too)")
        summary.append(entry)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
