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

Under "float32" the product is `torch.bmm`. The port's Linear,
`grouped_linear(x, w, b)`, runs on CUDA f32 tensors as `_F32Linear`
(`f32_linear`, with the layer's bias): the forward `x @ w + b` and the input
gradient `dy @ w^T` are `grouped_mm.product` (a hand-written 3xTF32 kernel
that adds the bias in its epilogue where `grouped_mm.mm_route` sends the
shape, else cuBLAS and a separate add), the weight gradient `x^T dy`, a sum
over the many rows of x into a small (G, K, N), is
`grouped_dw.weight_gradient` (a hand-written split-K kernel where
`grouped_dw.dw_route` sends the shape, else cuBLAS), and the bias gradient
the column sum of dy. The CPU keeps `torch.bmm`, the add and their
autograd.
"""

from __future__ import annotations

import torch

from codebase_tpu_torch.ops import grouped_dw, grouped_mm


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


class _F32Linear(torch.autograd.Function):
    """The f32 Linear on CUDA tensors: forward and dX `grouped_mm.product`,
    dW `grouped_dw.weight_gradient`, db the column sum of dy."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return grouped_mm.product(x, w, b, "linear/fwd")

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = grouped_mm.product(dy, w, None, "linear/dx")
        if ctx.needs_input_grad[1]:
            dw = grouped_dw.weight_gradient(x, dy)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.sum(1)
        return dx, dw, db


def takes_f32_linear(x, w) -> bool:
    """Whether `f32_linear` forms x @ w: CUDA tensors in f32."""
    return x.is_cuda and x.dtype == torch.float32 and w.dtype == torch.float32


def f32_linear(x, w, b=None):
    """x (G, R, K) @ w (G, K, N) (+ b (G, N)) of CUDA f32 tensors, through
    `_F32Linear` where a gradient is taken, else its forward alone."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        return _F32Linear.apply(x, w, b)
    return grouped_mm.product(x, w, b, "linear/fwd")


def grouped_linear(x, w, b, compute_dtype: str = "float32"):
    """x (G, ..., K) @ w (G, K, N) + b (G, N) -> (G, ..., N): every Linear
    layer and GRU input projection of the port. On CUDA f32 tensors one call
    (`f32_linear`: the bias in the product's epilogue); elsewhere
    `grouped_matmul`, then the add."""
    G, N = x.shape[0], w.shape[-1]
    x2 = x.reshape(G, -1, x.shape[-1])
    if compute_dtype == "float32" and takes_f32_linear(x2, w):
        return f32_linear(x2, w, b).view(*x.shape[:-1], N)
    y = grouped_matmul(x2, w, compute_dtype).view(*x.shape[:-1], N)
    return y + b.view((G,) + (1,) * (x.ndim - 2) + (N,))


def grouped_matmul(x, w, compute_dtype: str = "float32"):
    """x (G, M, K) @ w (G, K, N): `torch.bmm` in the inputs' dtype under
    "float32", with bf16 inputs and an f32 result under "bfloat16". The f32
    Linear of CUDA tensors is `grouped_linear`'s."""
    if compute_dtype == "bfloat16":
        return _BF16Matmul.apply(x, w)
    return torch.bmm(x, w)
