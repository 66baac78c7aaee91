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
    mean: torch.Tensor  # (D,)
    var: torch.Tensor  # (D,)
    count: torch.Tensor  # () float32

    @staticmethod
    def init(shape, epsilon: float = 1e-4, device="cpu") -> "RunningMeanStd":
        return RunningMeanStd(
            mean=torch.zeros(shape, device=device),
            var=torch.ones(shape, device=device),
            count=torch.tensor(epsilon, dtype=torch.float32, device=device),
        )

    def update(self, arr: torch.Tensor) -> "RunningMeanStd":
        """Merge a batch of samples; arr is reshaped to (-1, D)."""
        arr = arr.reshape(-1, arr.shape[-1]).float()
        batch_count = arr.shape[0]
        batch_mean = arr.mean(0)
        batch_var = arr.var(0, correction=1) if batch_count > 1 else torch.zeros_like(batch_mean)
        # a row count is exact in f32 up to 2**24, so the Python number
        # rounds as the JAX package's f32 array does
        batch_count = float(batch_count)
        delta = batch_mean - self.mean
        tot_count = self.count + batch_count
        new_mean = self.mean + delta * batch_count / tot_count
        m_a = self.var * self.count
        m_b = batch_var * batch_count
        m_2 = m_a + m_b + delta.square() * self.count * batch_count / tot_count
        return RunningMeanStd(mean=new_mean, var=m_2 / tot_count, count=tot_count)

    def normalise(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / torch.sqrt(self.var)

    def denormalise(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sqrt(self.var) + self.mean
