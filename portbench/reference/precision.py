"""The precisions a reference computes in: ``f64`` (the reference), ``f32``
with TF32 off, and ``tf32``, the control: every product's operands rounded
to TF32's 10-bit mantissa and summed in float32, as a TF32 tensor-core
product does, in the forward and in the backward."""

from __future__ import annotations

import torch

PRECISIONS = ("f64", "f32", "tf32")


def dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return torch.float64 if precision == "f64" else torch.float32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties to even)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _RoundOperand(torch.autograd.Function):
    """TF32 rounding of a product's operand; the gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundIncoming(torch.autograd.Function):
    """Identity forward; rounds the gradient that enters the product's
    backward, whose two products then take TF32 operands as well."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in ``precision``; on a card TF32 is off for the call, so
    ``f32`` is full float32 and ``tf32`` only what the rounding makes it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if precision == "tf32":
            return _RoundIncoming.apply(_RoundOperand.apply(a) @ _RoundOperand.apply(b))
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
