"""The reference's one matrix product, at the precision a run asks for.

``Numerics("float32")`` multiplies in float32 with TF32 off, as the plain
reference must.  ``Numerics("fp8")`` is the control: the same product with
both operands rounded to float8 first (e4m3 in the forward, e5m2 for the
gradients in the backward, one scale per tensor from its largest
magnitude), the step below bfloat16 that a later change might be tempted
to take.  Every product of the reference goes through ``Numerics.mm``, so
the control lowers all of them and nothing else.
"""
from __future__ import annotations

import torch

F32 = torch.float32
# the largest finite magnitudes of the two float8 formats
_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0
PRECISIONS = ("float32", "fp8")


def set_strict_float32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor, fmt: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``fmt`` under one scale per tensor, back in float32."""
    amax = x.detach().abs().amax().to(F32)
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(fmt).to(F32) * scale


class _Fp8Product(torch.autograd.Function):
    """``a @ b`` with both operands in float8 (e4m3); the backward's products
    take the incoming gradient in float8 e5m2 and the saved operands in
    e4m3."""

    @staticmethod
    def forward(ctx, a, b):
        a8 = round_fp8(a, torch.float8_e4m3fn, _E4M3_MAX)
        b8 = round_fp8(b, torch.float8_e4m3fn, _E4M3_MAX)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = round_fp8(g, torch.float8_e5m2, _E5M2_MAX)
        return g8 @ b8.transpose(-1, -2), a8.transpose(-1, -2) @ g8


class Numerics:
    def __init__(self, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}, not one of "
                             f"{PRECISIONS}")
        self.precision = precision

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` (matmul broadcasting) in float32 or through float8."""
        a, b = a.to(F32), b.to(F32)
        if self.precision == "fp8":
            return _Fp8Product.apply(a, b)
        return a @ b
