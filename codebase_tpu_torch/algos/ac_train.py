"""Actor-critic training loop on the host: the loop over train iterations.

Logs the training rollouts' own episodes, as the JAX package's
`ac_train.main` does (there is no separate eval). The iterations run in
chunks of `min(256, max(1, log_interval // (E * T)))` (10,000 steps when no
interval is set), the JAX package's jitted chunks; `log_interval` falls back
to `eval_interval`. After a chunk that crosses `log_interval`, the row holds
the chunk's last iteration: its per-episode infos, its `loss`,
`actor_loss`, `value_loss` and `entropy`, `updates` and
`environment_steps`.

Also as the JAX package's loop does: `resume` (a checkpoint path, or `auto`
for the latest under `<run_dir>/checkpoints`) restores the full train state
right after it is built, and the cadences count from the resumed step;
after each chunk, a video of the sampling policy every `video_interval`
steps (`<run_dir>/videos/step-{step}.mp4`) and a checkpoint every
`save_interval` (`<run_dir>/checkpoints/model_s{step}.msgpack`), plus one at
the end; a SIGTERM makes the loop checkpoint after the chunk in flight and
stop.

A data-parallel run (`shard`) runs this loop in step on every rank, as
`dqn_train.py` does; the logged episodes are gathered from all ranks.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from codebase_tpu_torch.algos.ac import METRICS, build_train_functions
from codebase_tpu_torch.parallel import mesh
from codebase_tpu_torch.utils.checkpoint import resume_train_state, save_train_state
from codebase_tpu_torch.utils.device import sync
from codebase_tpu_torch.utils.loggers import episode_infos
from codebase_tpu_torch.utils.preemption import PreemptionGuard
from codebase_tpu_torch.utils.video import record_episodes


def main(env, eval_env, logger, time_limit, cfg, device, shard=None):
    acfg = cfg.algorithm
    init_state, train_iteration, _, _ = build_train_functions(env, eval_env, acfg, time_limit, device, shard=shard,
                                                              debug=bool(cfg.get("debug")))
    seed = cfg.get("seed")
    seed = int(seed) if seed is not None else int(np.random.randint(2**31 - 1))
    state = init_state(seed)
    run_dir = Path(getattr(logger, "run_dir", "."))
    resume_train_state(state, cfg.get("resume"), run_dir, logger)
    logger.watch(state.model)

    total_steps = int(acfg.total_steps)
    log_interval = int(acfg.log_interval) if acfg.get("log_interval") else 0
    eval_interval = int(acfg.eval_interval) if acfg.eval_interval else 0
    log_interval = log_interval or eval_interval
    save_interval = int(acfg.save_interval) if acfg.get("save_interval") else 0
    video_interval = int(acfg.video_interval) if acfg.get("video_interval") else 0
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
    last_log = last_save = last_video = step
    with PreemptionGuard() as guard:
        while step < total_steps + 1:
            for _ in range(chunk_iters):
                sync(device)
                t0 = time.perf_counter()
                metrics = train_iteration(state)
                losses = {k: float(metrics[k]) for k in METRICS}  # waits for the update
                state.timings.append((state.env_steps - step, time.perf_counter() - t0))
                step = state.env_steps
            preempt = mesh.sync_flag(guard.triggered)  # every rank saves and stops together

            if log_interval and (step - last_log) >= log_interval:
                infos = episode_infos(mesh.fetch_metrics(metrics, shard))  # every rank's envs
                infos.append(losses)
                infos.append({"updates": state.updates, "environment_steps": step})
                logger.log_metrics(infos)
                last_log = step

            if video_interval and (step - last_video) >= video_interval:
                if mesh.is_coordinator():
                    record_episodes(
                        eval_env, state.model.policy(), state.model.actor.init_hiddens(1),
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

        # the final state (see dqn_train.py)
        if save_interval and step > last_save:
            save_train_state(state, run_dir, step, logger)
    return state
