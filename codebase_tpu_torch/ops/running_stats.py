"""Streaming mean and variance (Chan's parallel merge) for return
standardisation.

The same rules as the JAX package's `RunningMeanStd`: the initial count is
1e-4 in f32, the batch variance is unbiased (ddof=1) and 0 for a batch of
one row. The statistics are immutable: `update` returns a new object, so the
loss can hand the updated moments back to the train state. Tensors live on
the device of the state they were made for.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RunningMeanStd:
    mean: torch.Tensor  # (D,), or (U, D) for U units
    var: torch.Tensor  # (D,), or (U, D)
    count: torch.Tensor  # () float32, or (U,)

    @staticmethod
    def init(shape, epsilon: float = 1e-4, device="cpu", n_units: int = 1) -> "RunningMeanStd":
        lead = (n_units,) if n_units > 1 else ()
        return RunningMeanStd(
            mean=torch.zeros(lead + tuple(shape), device=device),
            var=torch.ones(lead + tuple(shape), device=device),
            count=torch.full(lead, epsilon, dtype=torch.float32, device=device),
        )

    @property
    def n_units(self) -> int:
        return self.count.numel()

    def update(self, arr: torch.Tensor, shard=None) -> "RunningMeanStd":
        """Merge a batch of samples; arr is reshaped to (-1, D), or to
        (U, -1, D) for U units. With a `shard` that splits the envs over W
        ranks, `arr` is this rank's equal share of the batch, and the
        batch's mean and variance are the whole batch's (two `all_reduce`s:
        the sum, then the squared deviations from the mean)."""
        U, D = self.n_units, self.mean.shape[-1]
        arr = arr.reshape(U, -1, D).float()
        if shard is not None and shard.splits_envs and shard.world > 1:
            batch_count = arr.shape[1] * shard.world
            batch_mean = shard.all_reduce(arr.sum(1), kind="moments") / batch_count
            sq = shard.all_reduce((arr - batch_mean[:, None]).square().sum(1), kind="moments")
            batch_var = sq / (batch_count - 1)
        else:
            batch_count = arr.shape[1]
            batch_mean = arr.mean(1)
            batch_var = arr.var(1, correction=1) if batch_count > 1 else torch.zeros_like(batch_mean)
        # a row count is exact in f32 up to 2**24, so the Python number
        # rounds as the JAX package's f32 array does
        batch_count = float(batch_count)
        mean, var, count = self.mean.reshape(U, D), self.var.reshape(U, D), self.count.reshape(U, 1)
        delta = batch_mean - mean
        tot_count = count + batch_count
        new_mean = mean + delta * batch_count / tot_count
        m_a = var * count
        m_b = batch_var * batch_count
        m_2 = m_a + m_b + delta.square() * count * batch_count / tot_count
        return RunningMeanStd(mean=new_mean.reshape(self.mean.shape), var=(m_2 / tot_count).reshape(self.var.shape),
                              count=tot_count.reshape(self.count.shape))

    def where(self, units: torch.Tensor, other: "RunningMeanStd") -> "RunningMeanStd":
        """These moments for the units marked True (a (U,) bool tensor),
        `other`'s for the rest."""
        return RunningMeanStd(*(torch.where(units.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
                                for a, b in ((self.mean, other.mean), (self.var, other.var),
                                             (self.count, other.count))))

    def _over(self, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """A (U, D) moment broadcast over x (U, ..., D)."""
        return t if t.ndim == 1 else t.reshape(t.shape[:1] + (1,) * (x.ndim - 2) + t.shape[1:])

    def normalise(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self._over(self.mean, x)) / torch.sqrt(self._over(self.var, x))

    def denormalise(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sqrt(self._over(self.var, x)) + self._over(self.mean, x)
