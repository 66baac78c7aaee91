"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

from codebase_tpu_torch.parallel import mesh


def resolve_device(name) -> torch.device:
    """`cuda` (the default) or `cpu`. `cuda` without a visible GPU raises:
    an entry point never carries on quietly on the CPU. In a rank of a
    data-parallel run `cuda` is the rank's GPU; every rank calls this, so
    each pins its own matmul precision.

    Also pins float32 matmuls and convolutions to full precision
    (`allow_tf32 = False`), so the `torch.matmul` projections around the GRU
    kernel stay f32 like the JAX reference."""
    dev = torch.device(str(name))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device=cuda was requested but no CUDA GPU is visible")
        if dev.index is None:
            # a rank of a data-parallel run takes its own GPU
            ranked = mesh.rank_device()
            dev = ranked if ranked is not None and ranked.type == "cuda" else torch.device(
                "cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu; got {name!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
