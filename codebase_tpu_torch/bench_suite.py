"""Benchmark suite of the port: env-steps/s, MFU and HBM use of every lane.

The counterpart of the JAX package's `bench_suite.py`, with its ten lanes
(`CONFIGS`, the same keys, algorithms, envs, time limits and overrides) and
its analytic matmul count (`analytic_flops`), on the GPU:

    python -m codebase_tpu_torch.bench_suite [--only idqn_lbf] [--windows 3] [--device cuda]
    python -m codebase_tpu_torch.bench            # headline + embedded suite, one JSON line

`run_config` builds a lane's train iteration, warms up one window, times
`windows` windows of `window_iters` iterations (`utils/profiling.time_windows`:
each window ends in a device sync, the counters are read outside it), keeps
the best, then runs one more iteration, untimed, under
`utils/profiling.count_operations`, the counterpart of XLA's cost analysis:
its operations and bytes give `flops_per_step` and `bytes_per_step`.

    MFU = analytic matmul flops of the best window / its seconds / peak

The peak follows the lane's arithmetic: the f32 lanes run their products in
full f32 (TF32 is off, `utils/device.py`), so their peak is the card's f32
FFMA rate; the bf16 lanes (`dtype=bfloat16`) take the dense bf16 tensor-core
rate. `hbm_bandwidth_util` is the counted bytes an iteration over its time,
over the card's HBM rate: the count is of bytes addressed, some of which
the L2 serves, so it is an estimate and may exceed 1. On a card that
`PEAKS` does not list, or on the CPU, both read null: no peak is assumed.
"""

from __future__ import annotations

import argparse
import json

import torch

from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.ops import fused_gru
from codebase_tpu_torch.profile import BUILDERS, FAMILIES, card
from codebase_tpu_torch.run import build_envs
from codebase_tpu_torch.utils import profiling
from codebase_tpu_torch.utils.device import resolve_device

# Published peaks of one card, dense, no sparsity (NVIDIA data sheets), keyed
# by the name the card reports (`nvidia-smi`, `torch.cuda.get_device_name`):
# HBM bytes/s, f32 FFMA flop/s (outside the tensor cores), TF32 and bf16
# tensor-core flop/s. The SXM and PCIe parts differ.
PEAKS = {
    "H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12, "tf32_flops": 495e12,
                       "bf16_flops": 989e12},  # SXM
    "H100 PCIe": {"hbm_bytes_per_s": 2.0e12, "fp32_flops": 51e12, "tf32_flops": 378e12, "bf16_flops": 756e12},
}

# The ten lanes of the JAX package's suite. `overrides` are dot-path config
# overrides on top of the algorithm preset; the widths are the JAX package's.
CONFIGS = {
    "idqn_lbf": dict(
        algo="idqn",
        env="lbforaging:Foraging-8x8-2p-3f-v3",
        time_limit=25,
        overrides=[
            "algorithm.parallel_envs=65536",
            "algorithm.batch_size=512",
            "algorithm.updates_per_collect=8",
            "algorithm.buffer_size=65536",
            "algorithm.training_start=0",
            # throughput lanes use the clean insert: the default
            # reference-quirk slot reuse (stale-tail merge, ops/replay.py)
            # re-reads every overwritten slot block per iteration, which
            # only matters for wide-collect benches, not the parity gate
            "algorithm.replay_slot_reuse=clear",
            # LBF episodes run about the full T, so the early-exit
            # collector's per-step check is pure overhead here; early exit
            # stays on (auto) only for the SMAClite lanes, whose episodes
            # end well before T
            "algorithm.rollout_early_exit=off",
        ],
    ),
    "ia2c_lbf": dict(
        algo="ia2c",
        env="lbforaging:Foraging-8x8-2p-3f-v3",
        time_limit=25,
        overrides=[
            "algorithm.parallel_envs=8192",
            "algorithm.rollout_early_exit=off",  # see the idqn_lbf note
        ],
    ),
    "vdn_shared_lbf10": dict(
        algo="vdn",
        env="lbforaging:Foraging-10x10-3p-3f-v3",
        time_limit=25,
        overrides=[
            "algorithm.model.parameter_sharing=true",
            # the JAX package's tuned width; more envs bought it nothing
            "algorithm.parallel_envs=32768",
            "algorithm.batch_size=512",
            "algorithm.updates_per_collect=8",
            "algorithm.buffer_size=65536",
            "algorithm.training_start=0",
            "algorithm.replay_slot_reuse=clear",  # see the idqn_lbf note
            "algorithm.rollout_early_exit=off",  # see the idqn_lbf note
        ],
    ),
    "qmix_rware": dict(
        algo="qmix",
        env="rware-tiny-2ag-v2",
        time_limit=500,
        overrides=[
            # the width is capped by the T=500 rollout buffers, which grow
            # with the envs
            "algorithm.parallel_envs=8192",
            "algorithm.batch_size=128",
            "algorithm.updates_per_collect=8",
            "algorithm.buffer_size=16384",
            "algorithm.training_start=0",
            "algorithm.replay_slot_reuse=clear",  # see the idqn_lbf note
            # RWARE episodes always run the full T=500 (no terminal state):
            # the early-exit check never fires and only costs
            "algorithm.rollout_early_exit=off",
        ],
    ),
    "qmix_smaclite_3m": dict(
        algo="qmix",
        env="smaclite:3m-v0",
        time_limit=60,
        overrides=[
            # the lane is bound by the fixed per-step chain of small ops, so
            # many envs a step amortise it; buffer == E: each collect
            # replaces the whole ring
            "algorithm.parallel_envs=65536",
            "algorithm.batch_size=256",
            "algorithm.updates_per_collect=8",
            "algorithm.buffer_size=65536",
            "algorithm.training_start=0",
            "algorithm.replay_slot_reuse=clear",  # see the idqn_lbf note
        ],
    ),
    # Compute-dominant lane: MMM2 (10 allies vs 12 enemies, 3 unit types),
    # 512-unit GRU policies with parameter sharing, bf16 matmul inputs: the
    # regime where the matrix units engage (the per-step GRU product is
    # (E*10, 512) @ (512, 1536)). Env-steps/s is not the point here; MFU is.
    "qmix_smaclite_mmm2_big": dict(
        algo="qmix",
        env="smaclite:MMM2-v0",
        time_limit=120,
        overrides=[
            "algorithm.model.use_rnn=true",
            "algorithm.model.layers=[512,512]",
            "algorithm.model.parameter_sharing=true",
            "algorithm.model.dtype=bfloat16",
            "algorithm.parallel_envs=2048",
            # the iteration is update-dominated, and the update's MFU rises
            # with the batch; 256 is the JAX package's largest that fit its
            # memory (the 121-step BPTT working set)
            "algorithm.batch_size=256",
            "algorithm.updates_per_collect=8",
            "algorithm.buffer_size=2048",
            "algorithm.training_start=0",
            "algorithm.replay_slot_reuse=clear",
        ],
    ),
    # The actor-critic counterpart: the same MMM2 scale through the
    # on-policy update (PPO epochs, a centralised critic over the whole
    # (T, E) batch, shared 2x512 GRU actor and critic, bf16).
    "mappo_smaclite_mmm2_big": dict(
        algo="mappo",
        env="smaclite:MMM2-v0",
        time_limit=120,
        overrides=[
            "algorithm.model.actor.use_rnn=true",
            "algorithm.model.actor.layers=[512,512]",
            "algorithm.model.actor.parameter_sharing=true",
            "algorithm.model.actor.dtype=bfloat16",
            "algorithm.model.critic.use_rnn=true",
            "algorithm.model.critic.layers=[512,512]",
            "algorithm.model.critic.parameter_sharing=true",
            "algorithm.model.critic.dtype=bfloat16",
            # the 4-epoch PPO BPTT holds (T, N, E, H) activation chains for
            # the actor and the centralised critic; 256 envs is the JAX
            # package's width that fit its memory
            "algorithm.parallel_envs=256",
        ],
    ),
    # Reference-shape lane: every other throughput lane benches a best-case
    # shape nobody trains (training_start=0, updates_per_collect=8, buffer
    # == collect width, clean slot reuse). This one keeps the reference's
    # training semantics (slot-reuse quirk on, the default;
    # training_start=2000, batch_size=32, one update per collect, the
    # reference's one update an episode; a buffer of 16384 episodes >> the
    # collect width), so the suite bounds realistic training throughput.
    # Collect width 1024 is the only concession to the vector rollout.
    "idqn_lbf_refshape": dict(
        algo="idqn",
        env="lbforaging:Foraging-8x8-2p-3f-v3",
        time_limit=25,
        overrides=[
            "algorithm.parallel_envs=1024",
            "algorithm.rollout_early_exit=off",  # LBF (see the idqn_lbf note)
            "algorithm.batch_size=32",
            "algorithm.updates_per_collect=1",
            "algorithm.buffer_size=16384",
            "algorithm.training_start=2000",
        ],
    ),
    # Recurrent IDQN: BPTT through the GRU over whole episodes, batch 1024
    # (the JAX package's tuned batch: larger ones bought nothing at this
    # lane's metric). The port's fused_rnn=auto takes the GRU kernels
    # (`models/networks.py`, H=128: gru_fwd_kernel, gru_bwd_kernel).
    "idqn_rnn_lbf": dict(
        algo="idqn",
        env="lbforaging:Foraging-8x8-2p-3f-v3",
        time_limit=25,
        overrides=[
            "algorithm.model.use_rnn=true",
            "algorithm.rollout_early_exit=off",  # LBF (see the idqn_lbf note)
            "algorithm.parallel_envs=65536",
            "algorithm.batch_size=1024",
            "algorithm.updates_per_collect=8",
            "algorithm.buffer_size=131072",
            "algorithm.training_start=0",
            "algorithm.replay_slot_reuse=clear",  # see the idqn_lbf note
        ],
    ),
    # Identical sizes with the kernels off: the port's per-step GRU cell (a
    # yardstick, not a fallback), so the suite records the kernels' gain
    # directly.
    "idqn_rnn_lbf_scan": dict(
        algo="idqn",
        env="lbforaging:Foraging-8x8-2p-3f-v3",
        time_limit=25,
        overrides=[
            "algorithm.model.use_rnn=true",
            "algorithm.model.fused_rnn=off",
            "algorithm.rollout_early_exit=off",  # LBF (see the idqn_lbf note)
            "algorithm.parallel_envs=65536",  # matched to idqn_rnn_lbf
            "algorithm.batch_size=1024",
            "algorithm.updates_per_collect=8",
            "algorithm.buffer_size=131072",
            "algorithm.training_start=0",
            "algorithm.replay_slot_reuse=clear",  # see the idqn_lbf note
        ],
    ),
}


def _fwd_macs_per_row(input_size: int, hidden: tuple, output_size: int, use_rnn) -> int:
    """Matmul MACs for ONE agent-row through the net (one timestep).

    MLP: in->h1->...->out. RNN (`models/networks.py` `RNNSpec`): first
    Linear in->H, L GRU/LSTM layers (w_ih H x gH + w_hh H x gH; g=3 for GRU,
    4 for LSTM), final Linear H->out.

    L is len(hidden), one more recurrent layer than `RNNSpec` builds from
    `layers` (len(hidden) - 1), as in the JAX package's count: kept, so that
    the two packages' MFU compare; `count_operations`' `flops_per_step` has
    no such excess."""
    if not use_rnn:
        dims = (input_size,) + tuple(hidden) + (output_size,)
        return sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    H = hidden[0]
    g = 4 if str(use_rnn).lower() == "lstm" else 3
    return input_size * H + len(hidden) * (H * g * H * 2) + H * output_size


def analytic_flops(env, acfg, time_limit: int, n_updates: int):
    """Matmul-only useful-FLOPs model, the MFU numerator.

    Returns (rollout_flops_per_env_step, update_flops_per_iteration), or
    None for a model it does not know. MFU counts USEFUL model flops: the
    rollout term is per *collected* env step (finished envs' padding work is
    real execution but not model throughput), and each update runs online
    fwd + target fwd + backward (~2x fwd) over (T+1) x batch rows.

    `count_operations` counts every product the iteration runs, padding
    included; this count is the one both packages report as MFU, so their
    lanes compare."""
    model_cfg = acfg.model
    name = model_cfg.get("name", "qnetwork")
    if name in ("a2c", "ppo"):
        return _ac_analytic_flops(env, acfg, time_limit)
    if name not in ("qnetwork", "vdn", "qmix"):
        return None
    hidden = tuple(model_cfg.layers)
    use_rnn = model_cfg.use_rnn
    per_row = sum(
        _fwd_macs_per_row(env.obs_dims[i], hidden, env.action_dims[i], use_rnn)
        for i in range(env.n_agents)
    )
    T = time_limit
    B = int(acfg.batch_size)
    rollout_per_step = per_row * 2
    update = n_updates * B * (T + 1) * per_row * 2 * 4  # online+target+bwd(2x)
    if name == "qmix":
        mx = model_cfg.mixing
        S = sum(env.obs_dims)
        emb, hemb = int(mx.embed_dim), int(mx.hypernet_embed)
        N = env.n_agents
        layered = int(mx.hypernet_layers) >= 2
        hw1 = (S * hemb + hemb * N * emb) if layered else S * N * emb
        hw2 = (S * hemb + hemb * emb) if layered else S * emb
        per_tb = hw1 + hw2 + S * emb + (S * emb + emb) + (N * emb + emb)
        # 4x one mixer forward: online fwd (1) + backward (2) + target fwd
        # (1, no backward)
        update += n_updates * B * T * per_tb * 2 * 4
    return float(rollout_per_step), float(update)


def _ac_analytic_flops(env, acfg, time_limit: int):
    """AC-family (a2c/ppo) analytic matmul count.

    Rollout: one actor forward per collected env step. Update (once per
    iteration over the whole (T, E) batch): target-critic bootstrap forward
    over T+1 rows, then `num_epochs` x (actor fwd+bwd + critic fwd+bwd,
    ~3x a forward each) over T rows (`algos/ac.py`)."""
    model_cfg = acfg.model
    hidden_a = tuple(model_cfg.actor.layers)
    hidden_c = tuple(model_cfg.critic.layers)
    centralised = bool(model_cfg.critic.centralised)
    rnn_a = model_cfg.actor.use_rnn
    rnn_c = model_cfg.critic.use_rnn
    actor_row = sum(
        _fwd_macs_per_row(env.obs_dims[i], hidden_a, env.action_dims[i], rnn_a)
        for i in range(env.n_agents)
    )
    critic_in = [sum(env.obs_dims)] * env.n_agents if centralised else env.obs_dims
    critic_row = sum(
        _fwd_macs_per_row(critic_in[i], hidden_c, 1, rnn_c)
        for i in range(env.n_agents)
    )
    T = time_limit
    E = int(acfg.get("parallel_envs", 1))
    epochs = int(acfg.get("num_epochs", 1)) if model_cfg.get("name") == "ppo" else 1
    rollout_per_step = actor_row * 2
    update = (T + 1) * E * critic_row * 2  # target-critic bootstrap fwd
    update += epochs * T * E * (actor_row + critic_row) * 2 * 3  # fwd+bwd(2x)
    return float(rollout_per_step), float(update)


def card_peaks(name: str):
    """`PEAKS`' entry for a card's name, or None for a card it does not list."""
    return next((v for k, v in PEAKS.items() if k in name), None)


def mfu_peak(acfg) -> str:
    """The `PEAKS` key an MFU of this config is taken against: `bf16_flops`
    when a network computes in bf16, else `fp32_flops`."""
    model = acfg.model
    nets = [model.actor, model.critic] if "actor" in model else [model]
    return "bf16_flops" if any(str(n.get("dtype", "float32")) == "bfloat16" for n in nets) else "fp32_flops"


def run_config(key: str, windows: int = 3, window_iters: int = 16, device="cuda") -> dict:
    """Measure one lane (see the module docstring). Returns env-steps/s,
    FLOPs/s, MFU, HBM use, the card, and the peak device memory and GRU
    launches of the timed windows (the launch counters are set to 0 before
    them)."""
    spec = CONFIGS[key]
    cfg = load_config(
        [f"+algorithm={spec['algo']}"]
        + [f"env.name={spec['env']}", f"env.time_limit={spec['time_limit']}"]
        + spec["overrides"]
    )
    dev = resolve_device(device)
    env, eval_env = build_envs(cfg)  # drops env.parallel_envs: the width is algorithm.parallel_envs
    T = spec["time_limit"]
    init_state, train_iteration = BUILDERS[FAMILIES[spec["algo"]]](env, eval_env, cfg.algorithm, T, dev)[:2]
    state = init_state(0)

    n_envs = int(cfg.algorithm.get("parallel_envs", 1))
    upc = cfg.algorithm.get("updates_per_collect", "auto")
    n_updates = n_envs if upc == "auto" else int(upc)
    analytic = analytic_flops(env, cfg.algorithm, T, n_updates)

    def step():
        train_iteration(state)

    def counters():
        return state.env_steps, state.updates

    profiling.time_windows(step, dev, 1, window_iters, counters)  # warmup
    on_gpu = dev.type == "cuda"
    if on_gpu:
        torch.cuda.reset_peak_memory_stats(dev)
    fused_gru.reset_launch_counts()
    timed = profiling.time_windows(step, dev, windows, window_iters, counters)
    launches = fused_gru.launch_counts()
    peak_memory = torch.cuda.max_memory_allocated(dev) / 2**30 if on_gpu else None
    best = max(timed, key=lambda w: w["steps"] / w["seconds"])
    best_rate, best_dt, best_steps = best["steps"] / best["seconds"], best["seconds"], best["steps"]

    # one more iteration, untimed, counted (the counters slow its host loop)
    with profiling.count_operations() as ops:
        counted, = profiling.time_windows(step, dev, 1, 1, counters)
    flops_per_iter, bytes_per_iter = ops["flops"], ops["bytes"]
    counted_steps = max(counted["steps"], 1)

    info = card(dev)
    peaks = card_peaks(info["name"])
    peak_key = mfu_peak(cfg.algorithm)
    bytes_per_s = bytes_per_iter * window_iters / best_dt
    if analytic:
        roll_per_step, upd_per_iter = analytic
        # useful model flops in the best window: the rollout counts only
        # COLLECTED steps
        analytic_window = roll_per_step * best_steps + upd_per_iter * window_iters
        analytic_per_s = analytic_window / best_dt
    else:
        analytic_window = analytic_per_s = None
    mfu_src = "analytic_matmul" if analytic_per_s else "counted_operations"
    mfu_flops = analytic_per_s or flops_per_iter * window_iters / best_dt
    return {
        "config": key,
        "algo": spec["algo"],
        "env": spec["env"],
        "env_steps_per_s": round(best_rate, 1),
        "flops_per_step": round(flops_per_iter / counted_steps, 1),
        "analytic_flops_per_step": round(analytic_window / max(best_steps, 1), 1) if analytic_window else None,
        "bytes_per_step": round(bytes_per_iter / counted_steps, 1),
        "device_flops_per_s": round(mfu_flops, 1) if mfu_flops else None,
        "mfu": round(mfu_flops / peaks[peak_key], 5) if (mfu_flops and peaks) else None,
        "mfu_source": mfu_src,
        "mfu_peak": peak_key,
        # bytes addressed over the best window's time, over the HBM rate: an
        # estimate (the L2 serves some of the bytes), not clipped
        "hbm_bandwidth_util": round(bytes_per_s / peaks["hbm_bytes_per_s"], 4) if peaks else None,
        "device_kind": info["name"],
        "card": info["nvidia_smi"],
        "window_iters": window_iters,
        "windows_s": [w["seconds"] for w in timed],
        "peak_device_memory_gib": peak_memory,
        "gru_launches_per_iter": {k: v / (windows * window_iters) for k, v in launches.items()},
    }


def run_suite(only=None, windows: int = 3, device="cuda") -> dict:
    results = {}
    for key in CONFIGS:
        if only and key != only:
            continue
        results[key] = run_config(key, windows=windows, device=device)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=sorted(CONFIGS), default=None)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    for res in run_suite(args.only, args.windows, args.device).values():
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
