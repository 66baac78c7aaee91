"""n-step returns as a sum of shifted slices.

The same function as the JAX package's `ops/returns.py`, quirks included:
    R_t = sum_{s=0}^{n-1} gamma^s * r_{t+s} * (1 - d_{t+s})
        + gamma^n * V_{t+n} * (1 - d_{t+n})
where every term with t+s >= T is dropped, the bootstrap too: values[T] is
never used, and the last `nsteps` positions are truncated sums. Rewards and
bootstrap values are masked by "state t is terminal" (done[:T]).
"""

from __future__ import annotations

import torch


def nstep_returns(rewards, done, values, nsteps: int, gamma: float):
    """rewards (T, B, N); done and values (T+1, B, N) for states 0..T ->
    (T, B, N) n-step returns. The terms are added in the JAX package's
    order: s = 0..n-1, then the bootstrap."""
    T = rewards.shape[0]
    pad = rewards.new_zeros((nsteps,) + tuple(rewards.shape[1:]))
    live = 1.0 - done[:T]
    r_masked = torch.cat([rewards * live, pad])
    v_masked = torch.cat([values[:T] * live, pad])
    out = torch.zeros_like(rewards)
    for s in range(nsteps):
        out = out + (gamma**s) * r_masked[s : s + T]
    return out + (gamma**nsteps) * v_masked[nsteps : nsteps + T]
