"""Video recording of policy rollouts.

`record_episodes` runs a policy on one env (a batch of one, on the policy's
device), takes each step's RGB frame from the env's host-side
`render_frame(state, index=0)` and saves a video. Episodes restart with a
fresh reset and fresh hiddens, as the JAX package's `utils/video.py` does.
Encoding is that module's: mp4 through imageio, GIF when the mp4 encoder
fails, and the raw frames in an `.npz` when imageio is not installed. It
logs which file it wrote.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

log = logging.getLogger("codebase_tpu_torch")


class VideoRecorder:
    def __init__(self, fps: int = 10):
        self.fps = fps
        self.frames = []

    def record_frame(self, frame: np.ndarray):
        self.frames.append(np.asarray(frame))

    def save(self, path) -> Path:
        """Encode the frames; returns the path written (its suffix says the
        encoding)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        try:
            import imageio
        except ImportError:
            out = path.with_suffix(".npz")
            np.savez_compressed(out, frames=np.stack(self.frames))
            log.info("imageio unavailable; saved %d raw frames to %s", len(self.frames), out)
            return out
        try:
            imageio.mimsave(str(path), self.frames, fps=self.fps)
            out = path
        except Exception as exc:
            out = path.with_suffix(".gif")
            log.warning("mp4 encode failed (%s: %s); falling back to %s", type(exc).__name__, exc, out)
            imageio.mimsave(str(out), self.frames, fps=self.fps)
        log.info("Saved %d frames to %s", len(self.frames), out)
        return out


@torch.no_grad()
def record_episodes(env, policy, init_carry, n_frames: int, path, device) -> Path:
    """Roll `policy` (the `collect_episodes` policy signature) on one env
    for `n_frames` steps, rendering each state before its step; an episode
    that ends restarts from a reset with the hiddens `init_carry` (the
    policy's initial carry for one env, or None). Draws come from a
    generator seeded 0 on `device`. Returns the file written."""
    recorder = VideoRecorder()
    generator = torch.Generator(device=device).manual_seed(0)
    done = True
    for _ in range(int(n_frames)):
        if done:
            state, ts = env.reset_batch(generator, 1)
            carry = init_carry
        recorder.record_frame(env.render_frame(state, 0))
        carry, actions = policy(carry, ts.obs, ts.action_mask, generator)
        state, ts = env.step_batch(state, actions, generator, ts.action_mask)
        done = bool(ts.done[0])
    return recorder.save(path)
