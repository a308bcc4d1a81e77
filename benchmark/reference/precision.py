"""Operand rounding for the control: float8 (e4m3) in place of bfloat16.

The configurations compute in bfloat16; the nearest precision below it is
8-bit floating point. ``fp8`` rounds an operand of a convolution or a
matrix product to e4m3 with one scale per tensor (its largest magnitude
onto e4m3's largest finite value, 448), as fp8 training scales it, or
from a given ``amax`` where the operand is one block of a larger one; the
gradient passes through unrounded.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, amax):
        scale = amax.clamp(min=1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def fp8(x: torch.Tensor, amax: torch.Tensor | None = None) -> torch.Tensor:
    return _Fp8.apply(x, x.detach().abs().amax() if amax is None else amax)
