"""Grouped matrix products with the JAX package's mixed precision.

`grouped_matmul(x (G, M, K), w (G, K, N), compute_dtype) -> (G, M, N)`.
Under "bfloat16" it is the JAX package's `_matmul`
(`codebase_tpu/models/networks.py:149-166`): both inputs rounded to bf16,
their products summed in f32, and an f32 result that is never rounded to
bf16. torch's bf16 product returns bf16, which would be a different
result, so:

- on the card the product is `torch.bmm(..., out_dtype=torch.float32)` on
  the bf16 tensors (a bf16 GEMM accumulating in f32);
- on the CPU, where `aten::bmm.dtype` has no kernel, it is an f32 product
  of the bf16-rounded inputs: the same exact products (8-bit mantissas),
  summed in f32.

The gradients follow JAX's transpose rule for that `dot_general`: each
input's cotangent is an f32 product of the incoming f32 cotangent with the
other, bf16-valued, operand, rounded to bf16 (the dtype of the cast input)
before it flows back through the cast.

Under "float32" the product is `torch.bmm`. On CUDA tensors whose weight
takes a gradient it runs as `_F32Matmul`: the forward and dX are
`torch.bmm`, and the weight gradient `x^T dy`, a sum over the many rows of
x into a small (G, K, N), is `grouped_dw.weight_gradient` (a hand-written
split-K kernel where `grouped_dw.dw_route` sends the shape, else cuBLAS).
The CPU keeps `torch.bmm` and its autograd.
"""

from __future__ import annotations

import torch

from codebase_tpu_torch.ops import grouped_dw


def _bf16_product(a, b):
    """a @ b, batched, of bf16 tensors: an f32 result."""
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _round_bf16(x, dtype):
    return x.to(torch.bfloat16).to(dtype)


class _BF16Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.dtypes = (x.dtype, w.dtype)
        return _bf16_product(xb, wb)

    @staticmethod
    def backward(ctx, dy):
        xb, wb = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _round_bf16(torch.bmm(dy, wb.to(dy.dtype).transpose(1, 2)), ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            dw = _round_bf16(torch.bmm(xb.to(dy.dtype).transpose(1, 2), dy), ctx.dtypes[1])
        return dx, dw


class _F32Matmul(torch.autograd.Function):
    """The f32 product on CUDA tensors: forward and dX `torch.bmm`, dW
    `grouped_dw.weight_gradient`."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.bmm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.bmm(dy, w.transpose(1, 2))
        if ctx.needs_input_grad[1]:
            dw = grouped_dw.weight_gradient(x, dy)
        return dx, dw


def grouped_matmul(x, w, compute_dtype: str = "float32"):
    """x (G, M, K) @ w (G, K, N): in the inputs' dtype under "float32",
    with bf16 inputs and an f32 result under "bfloat16"."""
    if compute_dtype == "bfloat16":
        return _BF16Matmul.apply(x, w)
    if x.is_cuda and x.dtype == torch.float32 and w.requires_grad and torch.is_grad_enabled():
        return _F32Matmul.apply(x, w)
    return torch.bmm(x, w)
