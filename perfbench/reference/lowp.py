"""Rounding of matmul and convolution operands to a lower precision, for the
controls: the reference computed one step below the precision a
configuration states (TF32 below float32, fp8 below bfloat16). Products and
sums stay float32, as on tensor cores that take such operands."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to float8_e4m3fn under one scale for the tensor, its
    largest magnitude mapped to 448."""
    x = x.float()
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _Round(torch.autograd.Function):
    """Rounds in the forward and rounds the gradient in the backward, so that
    a product's backward also takes rounded operands."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def rounded(fn):
    """``fn`` as an operation autograd can pass through."""
    return lambda x: _Round.apply(x, fn) if x.requires_grad else fn(x)


ROUNDINGS = {"tf32": rounded(tf32), "fp8": rounded(fp8)}
