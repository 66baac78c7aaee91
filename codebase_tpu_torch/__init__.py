"""PyTorch/CUDA port of `codebase_tpu` for one NVIDIA H100.

Module names mirror the JAX package so each counterpart is easy to find.
Entry points run on the GPU (`device: cuda`, `configs/default.yaml`) unless
the caller asks for the CPU with `device=cpu`; the fused GRU recurrence
(`ops/fused_gru.py`) runs as hand-written CUDA kernels (`csrc/fused_gru.cu`)
on CUDA tensors and as its plain PyTorch version on CPU tensors.
"""
