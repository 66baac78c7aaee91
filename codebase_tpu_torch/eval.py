"""Checkpoint evaluation CLI:
`python -m codebase_tpu_torch.eval path=<run_dir> [load_step=N] [eval_episodes=K] [seed=S] [video_frames=F] [video_path=P] [device=cpu]`.

As the JAX package's `eval.py`: reads the run's `config.yaml`, takes the
latest checkpoint under `<run_dir>/checkpoints` (or `model_s{N}.msgpack`),
rebuilds the model from the config and loads the checkpoint's `params`,
written by either package, then runs `eval_episodes` episodes (default: the
run's `algorithm.eval_episodes`) and logs the mean return, its std and the
mean length; with `video_frames`, it also records a video. The DQN family
acts epsilon-greedy at `eps_evaluation`, the actor-critic family samples
from its actor. Runs on the GPU unless `device=cpu` is given; `device=cuda`
without a GPU raises. Returns the (episodes, agents) returns.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

import torch
import yaml

from codebase_tpu_torch.config import Config
from codebase_tpu_torch.envs.vector import collect_episodes
from codebase_tpu_torch.run import build_envs
from codebase_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, tree_from_state_dict
from codebase_tpu_torch.utils.device import resolve_device
from codebase_tpu_torch.utils.video import record_episodes

log = logging.getLogger("codebase_tpu_torch")

DQN_FAMILY = ("idqn", "vdn", "qmix")


def build_policy(env, cfg, ckpt_state, device="cpu"):
    """(model, policy, init_carry) for a checkpointed run: the model made
    from `cfg` on `device`, the checkpoint's `params` (a raw state dict from
    `load_checkpoint`, of either package) loaded into it, its evaluation
    policy, and that policy's initial carry for n envs (`init_carry(n)`)."""
    name = cfg.algorithm.name
    if name in DQN_FAMILY:
        from codebase_tpu_torch.algos.dqn import DQNModel

        model = DQNModel.create(env, cfg.algorithm.model, cfg.algorithm, device=device)
    else:
        from codebase_tpu_torch.algos.ac import ACModel

        model = ACModel.create(env, cfg.algorithm.model, cfg.algorithm, device=device)
    model.load_params(tree_from_state_dict(model.param_tree(), ckpt_state["params"]))
    if name in DQN_FAMILY:
        return model, model.policy(float(cfg.algorithm.eps_evaluation)), model.critic.init_hiddens
    return model, model.policy(), model.actor.init_hiddens


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    overrides = dict(tok.split("=", 1) for tok in (argv if argv is not None else sys.argv[1:]))
    path = Path(overrides["path"])
    if not path.is_dir():
        raise ValueError(f"Path {path} does not exist or is not a directory.")
    device = resolve_device(overrides.get("device", "cuda"))

    cfg = Config(yaml.safe_load((path / "config.yaml").read_text()))
    env, _ = build_envs(cfg)
    if overrides.get("load_step"):
        ckpt_path = path / "checkpoints" / f"model_s{overrides['load_step']}.msgpack"
    else:
        ckpt_path = latest_checkpoint(path / "checkpoints")
    log.info("Loading checkpoint %s", ckpt_path)
    _, policy, init_carry = build_policy(env, cfg, load_checkpoint(ckpt_path), device)

    episodes = int(overrides.get("eval_episodes", cfg.algorithm.get("eval_episodes", 100)))
    generator = torch.Generator(device=device).manual_seed(int(overrides.get("seed", 0)))
    rollout, _ = collect_episodes(env, policy, init_carry(episodes), generator, episodes, int(cfg.env.time_limit))
    returns = rollout.episode_returns.cpu().numpy()
    log.info(
        "Evaluated %d episodes: mean return %.4f (std %.4f), mean length %.1f",
        episodes,
        returns.sum(-1).mean(),
        returns.sum(-1).std(),
        float(rollout.episode_lengths.mean()),
    )

    video_frames = int(overrides.get("video_frames", 0))
    if video_frames:
        out = record_episodes(env, policy, init_carry(1), video_frames,
                              Path(overrides.get("video_path", "eval.mp4")), device)
        log.info("Saved video to %s", out)
    return returns


if __name__ == "__main__":
    main()
