"""A GRU layer's forward and backward (BPTT over whole episodes) three ways.

    python -m codebase_tpu_torch.rnn_kernel_bench [--shapes 25x1024,100x512,500x256,25x8192]
        [--hidden 128] [--device cuda]

The counterpart of the JAX package's `scripts/rnn_kernel_bench.py`, on the
DQN-update-shaped workload: a loss over the outputs and final hidden state
of one GRU layer over (T, B, H), and its gradient with respect to the
layer's parameters. Times each of:

- `fused`: the port's layer (`ops/fused_gru.gru_layer_sequence`), whose
  recurrence runs the hand-written kernels (`gru_fwd_kernel`, then
  `gru_bwd_kernel`, `gru_dw_kernel` and `gru_reduce_kernel`);
- `plain`: the same layer with the recurrence as a loop of GRU-cell ops
  (`gru_sequence_plain`, the kernels' reference);
- `cudnn`: `torch.nn.GRU` with the same weights (cuDNN on the card).

Prints one JSON line per (T, B) with the three times (ms, device time
between CUDA events over 20 calls after a warm-up), the card's name and
power limit. On `--device cpu` (a smoke run: 3 calls) the fused route is
the plain version (a CPU tensor never reaches the kernels), so `fused_ms`
is null and the times are the host's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from codebase_tpu_torch.models.networks import gru_layer_init
from codebase_tpu_torch.ops.fused_gru import gru_layer_sequence, gru_sequence_plain
from codebase_tpu_torch.ops.matmul import grouped_linear
from codebase_tpu_torch.utils.device import resolve_device, sync


def _layer(H: int, device):
    """One GRU layer's params with a group axis of 1, and the same weights
    as a `torch.nn.GRU`."""
    params = {k: v[None].to(device).requires_grad_() for k, v in
              gru_layer_init(H, H, torch.Generator().manual_seed(0)).items()}
    gru = torch.nn.GRU(H, H).to(device)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(params["w_ih"][0].T)
        gru.weight_hh_l0.copy_(params["w_hh"][0].T)
        gru.bias_ih_l0.copy_(params["b_ih"][0])
        gru.bias_hh_l0.copy_(params["b_hh"][0])
    return params, gru


def _losses(params, gru, x, h0):
    """name -> a function that forms the loss and its gradient."""
    leaves = list(params.values())

    def fused():
        y, hT = gru_layer_sequence(params, x[None], h0[None])
        return torch.autograd.grad((y**2).sum() + (hT**2).sum(), leaves)

    def plain():
        gi = grouped_linear(x[None], params["w_ih"], params["b_ih"])
        y, hT = gru_sequence_plain(gi, params["w_hh"], params["b_hh"], h0[None])
        return torch.autograd.grad((y**2).sum() + (hT**2).sum(), leaves)

    def cudnn():
        y, hT = gru(x, h0[None])
        return torch.autograd.grad((y**2).sum() + (hT**2).sum(), list(gru.parameters()))

    return {"fused": fused, "plain": plain, "cudnn": cudnn}


def time_ms(fn, device, reps: int) -> float:
    fn()  # warm-up (the first call builds the kernels)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def bench(T: int, B: int, H: int, device, reps: int) -> dict:
    params, gru = _layer(H, device)
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((T, B, H), generator=gen, device=device)
    h0 = torch.zeros((B, H), device=device)
    fns = _losses(params, gru, x, h0)
    out = {f"{name}_ms": time_ms(fn, device, reps) for name, fn in fns.items()
           if name != "fused" or device.type == "cuda"}
    out.setdefault("fused_ms", None)
    return out


def _card(device) -> dict:
    if device.type != "cuda":
        return {"name": "cpu", "nvidia_smi": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return {"name": torch.cuda.get_device_name(device), "nvidia_smi": smi[0] if smi else None}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--shapes", default="25x1024,100x512,500x256,25x8192", help="comma list of TxB")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # cuda without a GPU raises
    card = _card(device)
    lines = []
    for shape in args.shapes.split(","):
        T, B = (int(v) for v in shape.split("x"))
        reps = 20 if device.type == "cuda" else 3
        line = {"metric": "gru_bptt", "T": T, "B": B, "H": args.hidden, **bench(T, B, args.hidden, device, reps),
                "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
