"""DQN-family training loop on the host: the loop over train iterations.

Runs the iterations in chunks and, after each chunk, decides whether to
evaluate and log, as the JAX package's `dqn_train.main` does with its
jitted chunks: `chunk_iters = min(256, max(1, finest cadence // (E * T)))`
iterations (10,000 steps when no cadence is set), so `results.csv` rows
fall at the same env steps, the run stops at the same step, and the `loss`
column is the nan-mean of the last chunk's losses.

Also as the JAX package's loop does: `resume` (a checkpoint path, or `auto`
for the latest under `<run_dir>/checkpoints`) restores the full train state
right after it is built, and the cadences count from the resumed step;
after each chunk, a video every `video_interval` steps
(`<run_dir>/videos/step-{step}.mp4`) and a checkpoint every `save_interval`
(`<run_dir>/checkpoints/model_s{step}.msgpack`), plus one at the end; a
SIGTERM makes the loop checkpoint after the chunk in flight and stop. The
eval generator is seeded from `seed + 1` whether or not the run resumed
(the JAX package's eval key comes from the seed, not the checkpoint).

In a data-parallel run (`shard`, `parallel/mesh.py`) every rank runs this
loop in step: the losses and env steps are the whole run's on every rank,
the eval runs whole on every rank, the ranks agree on the preemption flag
at every chunk boundary (`sync_flag`) and on the checkpoint they resume
from, and only rank 0 writes (`results.csv`, checkpoints, videos).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from codebase_tpu_torch.algos.dqn import build_train_functions
from codebase_tpu_torch.ops.schedules import epsilon_schedule
from codebase_tpu_torch.parallel import mesh
from codebase_tpu_torch.utils import profiling
from codebase_tpu_torch.utils.checkpoint import resume_train_state, save_train_state
from codebase_tpu_torch.utils.device import sync
from codebase_tpu_torch.utils.loggers import episode_infos
from codebase_tpu_torch.utils.preemption import PreemptionGuard
from codebase_tpu_torch.utils.video import record_episodes


def read_loss(metrics: dict) -> float:
    """The host loop's one read of an iteration's result, its loss, which
    waits for the iteration's updates (the host sync `sync/loss`)."""
    with profiling.host_sync("sync/loss"):
        return float(metrics["loss"])


def main(env, eval_env, logger, time_limit, cfg, device, shard=None):
    acfg = cfg.algorithm
    init_state, train_iteration, evaluate = build_train_functions(
        env, eval_env, acfg, time_limit, device, shard=shard, debug=bool(cfg.get("debug"))
    )
    seed = cfg.get("seed")
    seed = int(seed) if seed is not None else int(np.random.randint(2**31 - 1))
    state = init_state(seed)
    run_dir = Path(getattr(logger, "run_dir", "."))
    resume_train_state(state, cfg.get("resume"), run_dir, logger)
    logger.watch(state.model)
    eval_gen = torch.Generator(device=device).manual_seed(seed + 1)

    total_steps = int(acfg.total_steps)
    log_interval = int(acfg.log_interval) if acfg.get("log_interval") else 0
    eval_interval = int(acfg.eval_interval) if acfg.eval_interval else 0
    save_interval = int(acfg.save_interval) if acfg.get("save_interval") else 0
    video_interval = int(acfg.video_interval) if acfg.get("video_interval") else 0
    n_envs = int(acfg.get("parallel_envs", 1))
    max_steps_per_iter = n_envs * time_limit
    cadences = [c for c in (log_interval, eval_interval) if c]
    chunk_iters = min(256, max(1, (min(cadences) if cadences else 10_000) // max_steps_per_iter))
    for label, interval in (("eval_interval", eval_interval), ("log_interval", log_interval)):
        if interval and interval < max_steps_per_iter:
            logger.warning(
                f"{label}={interval} is below the {max_steps_per_iter} env steps "
                f"one training iteration advances ({n_envs} envs x T={time_limit}); "
                f"effective cadence is ~{max_steps_per_iter} steps"
            )
    eps_sched = epsilon_schedule(
        acfg.eps_decay_style,
        float(acfg.eps_decay_over),
        float(acfg.eps_start),
        float(acfg.eps_end),
        float(acfg.eps_exp_decay_rate),
        total_steps,
    )

    step = state.env_steps
    last_log = last_eval = last_save = last_video = step
    with PreemptionGuard() as guard:
        while step < total_steps + 1:
            losses = []
            for _ in range(chunk_iters):
                sync(device)
                t0 = time.perf_counter()
                metrics = train_iteration(state)
                losses.append(read_loss(metrics))
                state.timings.append((state.env_steps - step, time.perf_counter() - t0))
                step = state.env_steps
            preempt = mesh.sync_flag(guard.triggered)  # every rank saves and stops together

            # eval rollouts and training metrics merge into ONE results.csv
            # row when their cadences coincide
            infos = []
            do_eval = eval_interval and (step - last_eval) >= eval_interval
            do_log = log_interval and (step - last_log) >= log_interval
            if do_eval:
                infos.extend(episode_infos(evaluate(state, eval_gen)))
                last_eval = step
            if do_log:
                arr = np.asarray(losses)  # this chunk's only
                if np.any(~np.isnan(arr)):
                    infos.append({"loss": float(np.nanmean(arr))})
                last_log = step
            if infos:
                counters = {"updates": state.updates, "environment_steps": step}
                if do_log:
                    counters["epsilon"] = float(eps_sched(step))
                infos.append(counters)
                logger.log_metrics(infos)

            if video_interval and (step - last_video) >= video_interval:
                if mesh.is_coordinator():
                    record_episodes(
                        eval_env, state.model.policy(float(acfg.eps_evaluation)), state.model.critic.init_hiddens(1),
                        int(acfg.video_frames), run_dir / "videos" / f"step-{step}.mp4", device,
                    )
                last_video = step

            do_save = save_interval and (step - last_save) >= save_interval
            if preempt:
                logger.info(f"SIGTERM received: checkpointing at step {step} and exiting")
            if do_save or preempt:
                save_train_state(state, run_dir, step, logger)
                last_save = step
            if preempt:
                break

        # the final state: the interval arithmetic usually leaves the last
        # save short of the end, and a checkpointing run ends with its final
        # state on disk
        if save_interval and step > last_save:
            save_train_state(state, run_dir, step, logger)
    return state
