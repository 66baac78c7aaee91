"""Categorical policy utilities with action-mask support.

The same functions as the JAX package's `models/distributions.py`: every
function works on logits of shape (..., A) and maps over the leading axes
(agents, time, envs). Masked actions take the logit -1e8.
"""

from __future__ import annotations

import torch

from codebase_tpu_torch.parallel.mesh import draw

MASK_NEG = -1e8


def apply_mask(logits: torch.Tensor, mask) -> torch.Tensor:
    """logits * mask + (1 - mask) * -1e8; `mask` None leaves the logits."""
    if mask is None:
        return logits
    return logits * mask + (1.0 - mask) * MASK_NEG


def sample(generator: torch.Generator, logits: torch.Tensor, env_dim=None, unit_dim=None) -> torch.Tensor:
    """Sample actions, (..., A) logits -> (...) int64, by Gumbel-max (the
    rule of `jax.random.categorical`): argmax of logits + Gumbel noise.
    `env_dim` and `unit_dim` name the env and sweep-unit axes of the logits
    for a rank's draw (`parallel.mesh.draw`); None draws the logits' shape
    as it is."""
    u = draw(lambda s: torch.rand(s, generator=generator, device=logits.device, dtype=logits.dtype),
             logits.shape, env_dim, unit_dim)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def log_prob(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Log-probability of `actions` (...) under softmax(logits)."""
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, actions.long().unsqueeze(-1)).squeeze(-1)


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """Entropy of softmax(logits) along the last axis. An action whose
    probability is 0 (a masked logit) contributes 0, not 0 * -inf."""
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    plogp = torch.where(p > 0, p * logp, torch.zeros_like(logp))
    return -plogp.sum(-1)


def mode(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)
