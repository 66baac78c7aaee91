"""Actor-critic training loop on the host: the loop over train iterations.

Logs the training rollouts' own episodes, as the JAX package's
`ac_train.main` does (there is no separate eval). The iterations run in
chunks of `min(256, max(1, log_interval // (E * T)))` (10,000 steps when no
interval is set), the JAX package's jitted chunks; `log_interval` falls back
to `eval_interval`. After a chunk that crosses `log_interval`, the row holds
the chunk's last iteration: its per-episode infos, its `loss`,
`actor_loss`, `value_loss` and `entropy`, `updates` and
`environment_steps`. Checkpoints, resume, preemption handling and video
wait for a later slice (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import time

import numpy as np

from codebase_tpu_torch.algos.ac import METRICS, build_train_functions
from codebase_tpu_torch.utils.device import sync
from codebase_tpu_torch.utils.loggers import episode_infos


def main(env, eval_env, logger, time_limit, cfg, device):
    acfg = cfg.algorithm
    for key in ("save_interval", "video_interval"):
        if acfg.get(key):
            raise NotImplementedError(f"algorithm.{key} is not ported yet (ROADMAP.md Queue 1)")
    init_state, train_iteration, _, _ = build_train_functions(env, eval_env, acfg, time_limit, device)
    seed = cfg.get("seed")
    seed = int(seed) if seed is not None else int(np.random.randint(2**31 - 1))
    state = init_state(seed)
    logger.watch(state.model)

    total_steps = int(acfg.total_steps)
    log_interval = int(acfg.log_interval) if acfg.get("log_interval") else 0
    eval_interval = int(acfg.eval_interval) if acfg.eval_interval else 0
    log_interval = log_interval or eval_interval
    n_envs = int(acfg.get("parallel_envs", 1))
    max_steps_per_iter = n_envs * time_limit
    chunk_iters = min(256, max(1, (log_interval or 10_000) // max_steps_per_iter))
    if log_interval and log_interval < max_steps_per_iter:
        logger.warning(
            f"log_interval={log_interval} is below the {max_steps_per_iter} env steps "
            f"one training iteration advances ({n_envs} envs x T={time_limit}); "
            f"effective cadence is ~{max_steps_per_iter} steps"
        )

    step = state.env_steps
    last_log = step
    while step < total_steps + 1:
        for _ in range(chunk_iters):
            sync(device)
            t0 = time.perf_counter()
            metrics = train_iteration(state)
            losses = {k: float(metrics[k]) for k in METRICS}  # waits for the update
            state.timings.append((state.env_steps - step, time.perf_counter() - t0))
            step = state.env_steps
        if log_interval and (step - last_log) >= log_interval:
            infos = episode_infos(metrics)
            infos.append(losses)
            infos.append({"updates": state.updates, "environment_steps": step})
            logger.log_metrics(infos)
            last_log = step
    return state
