"""DQN-family training loop on the host: the loop over train iterations.

Runs the iterations in chunks and, after each chunk, decides whether to
evaluate and log, as the JAX package's `dqn_train.main` does with its
jitted chunks: `chunk_iters = min(256, max(1, finest cadence // (E * T)))`
iterations (10,000 steps when no cadence is set), so `results.csv` rows
fall at the same env steps, the run stops at the same step, and the `loss`
column is the nan-mean of the last chunk's losses. Checkpoints, resume,
preemption handling and video wait for a later slice (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from codebase_tpu_torch.algos.dqn import build_train_functions
from codebase_tpu_torch.ops.schedules import epsilon_schedule
from codebase_tpu_torch.utils.device import sync
from codebase_tpu_torch.utils.loggers import episode_infos


def main(env, eval_env, logger, time_limit, cfg, device):
    acfg = cfg.algorithm
    for key in ("save_interval", "video_interval"):
        if acfg.get(key):
            raise NotImplementedError(f"algorithm.{key} is not ported yet (ROADMAP.md Queue 1)")
    init_state, train_iteration, evaluate = build_train_functions(
        env, eval_env, acfg, time_limit, device
    )
    seed = cfg.get("seed")
    seed = int(seed) if seed is not None else int(np.random.randint(2**31 - 1))
    state = init_state(seed)
    logger.watch(state.model)
    eval_gen = torch.Generator(device=device).manual_seed(seed + 1)

    total_steps = int(acfg.total_steps)
    log_interval = int(acfg.log_interval) if acfg.get("log_interval") else 0
    eval_interval = int(acfg.eval_interval) if acfg.eval_interval else 0
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
    last_log = last_eval = step
    while step < total_steps + 1:
        losses = []
        for _ in range(chunk_iters):
            sync(device)
            t0 = time.perf_counter()
            metrics = train_iteration(state)
            losses.append(float(metrics["loss"]))  # waits for the iteration's updates
            state.timings.append((state.env_steps - step, time.perf_counter() - t0))
            step = state.env_steps

        # eval rollouts and training metrics merge into ONE results.csv row
        # when their cadences coincide
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
    return state
