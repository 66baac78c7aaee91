"""Shared training utilities: the optimizer, target-network updates and the
early-exit option of the episode collector."""

from __future__ import annotations

import numpy as np
import torch


class Adam:
    """Adam after a global-norm clip, with the JAX package's exact rules
    (`optax.chain(optax.clip_by_global_norm(c), optax.adam(lr))`):

    - clip: with `n = sqrt(sum_i |g_i|^2)` over all leaves, every gradient
      becomes `g` when `n < c`, else `(g / n) * c`. This is not
      `torch.nn.utils.clip_grad_norm_`, which scales by `c / (n + 1e-6)`;
    - Adam (torch-default hyperparameters b1=0.9, b2=0.999, eps=1e-8):
      `mu = (1-b1) g + b1 mu`, `nu = (1-b2) g^2 + b2 nu`, and the update
      `-lr * (mu / (1-b1^k)) / (sqrt(nu / (1-b2^k)) + eps)` at step k.

    `clip_mask` (one bool per parameter, or None for all) restricts both the
    norm and the scaling to the masked leaves; the others pass to Adam
    unclipped (`optax.masked(clip_by_global_norm(c), mask)`). QMIX clips the
    critic only, as the reference's `clip_grad_norm_(critic.parameters())`
    does: whole-tree clipping changed QMIX's learning in the JAX package.
    The actor-critic family runs one Adam over the whole {"actor", "critic"}
    tree, and a clip there covers every leaf.

    The clip decision stays on the device (`torch.where`), so a step never
    waits for the host. Parameters are updated in place.
    """

    def __init__(self, params, lr: float, grad_clip=None, b1=0.9, b2=0.999, eps=1e-8, clip_mask=None):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = float(lr), b1, b2, eps
        self.grad_clip = float(grad_clip) if grad_clip else None
        self.clip_mask = [True] * len(self.params) if clip_mask is None else [bool(m) for m in clip_mask]
        if len(self.clip_mask) != len(self.params):
            raise ValueError(f"clip_mask has {len(self.clip_mask)} entries for {len(self.params)} parameters")
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        grads = list(grads)
        if self.grad_clip is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g, m in zip(grads, self.clip_mask) if m))
            keep = g_norm < self.grad_clip
            grads = [
                torch.where(keep, g, (g / g_norm) * self.grad_clip) if m else g
                for g, m in zip(grads, self.clip_mask)
            ]
        self.count += 1
        # optax forms the bias corrections in the default float type: 1 -
        # f32(b)**count for float32 parameters, float64 where JAX runs in
        # 64-bit mode
        f = np.float64 if self.params[0].dtype == torch.float64 else np.float32
        bc1 = float(f(1.0) - f(self.b1) ** f(self.count))
        bc2 = float(f(1.0) - f(self.b2) ** f(self.count))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
            p.add_((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps), alpha=-self.lr)


def make_optimizer(name: str, params, lr: float, grad_clip=False, clip_mask=None) -> Adam:
    """Only Adam (the presets' optimizer) is ported so far."""
    if str(name).lower() != "adam":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet; use adam")
    return Adam(params, lr, grad_clip, clip_mask=clip_mask)


def early_exit_option(acfg):
    """The `rollout_early_exit` config key for `collect_episodes`: "auto"
    (the default: early exit at E >= 512 when the env can end early), or a
    forced True ("on") or False ("off"). Both give identical rollouts
    (`envs/vector.py`)."""
    opt = acfg.get("rollout_early_exit", "auto")
    if opt in ("auto", None):
        return "auto"
    if opt in ("on", True, "true"):
        return True
    if opt in ("off", False, "false"):
        return False
    raise ValueError(f"rollout_early_exit must be auto/on/off, got {opt!r}")


@torch.no_grad()
def hard_update(target_params, source_params) -> None:
    for t, s in zip(target_params, source_params):
        t.copy_(s)


@torch.no_grad()
def soft_update(target_params, source_params, tau: float) -> None:
    """Polyak update: target <- (1 - tau) * target + tau * source."""
    for t, s in zip(target_params, source_params):
        t.copy_((1.0 - tau) * t + tau * s)
