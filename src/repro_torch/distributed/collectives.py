"""Distributed-optimization collectives: compressed gradient all-reduce, the
sums of the tensor- and expert-parallel layers with their gradients, and
the sequence-parallel gathers and scatters of Megatron-SP.

``compressed_psum_mean`` quantizes to int8 with per-tensor scale and
stochastic rounding before the all-reduce, cutting bytes on the wire 4×
vs f32 (2× vs bf16); the error is zero-mean (tests bound it).  The
stochastic rounding draws its uniforms from an explicit ``torch.Generator``
through ``uniforms``, or takes them from the caller, so that a test can
replay another generator's draws.

A group is a ``torch.distributed`` process group or the name of an axis of
the installed mesh (``distributed.context.use_mesh``).

A tensor-parallel module enters its region with ``region_in`` and leaves
it with ``region_out``.  Without Megatron-SP they are the sum of the
input's gradient (``sum_grads``) and of the row-parallel product
(``psum``) over "model"; under ``context.use_seq_shard(True)`` the residual
stream holds this rank's S/n rows, so the input is all-gathered along the
sequence (its gradient reduce-scattered) and the product summed over
"model" and cut to the rank's rows (its gradient all-gathered).  A module
that runs whole on every rank (its heads or columns do not divide "model")
passes ``group=None``: no sum without SP; under SP its input is gathered
with a backward that keeps the rank's rows of the (whole, equal)
gradient, and its output split with a backward that gathers the rows'
gradients, so that every rank computes the same whole gradients of its
leaves.  The collectives are ``all_gather_into_tensor``, ``all_reduce``
and ``reduce_scatter_tensor``, which NCCL and gloo (CPU and CUDA tensors,
torch 2.11 and 2.13) all run.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .context import current_mesh, model_group, seq_sharded

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


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum of ``x`` over ``group``, no gradient."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis_group(group))
    return out


# ---------------------------------------------------------------------------
# Megatron-SP: the sequence gathered into a region and scattered out of it
# ---------------------------------------------------------------------------


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` concatenated along ``dim`` in rank
    order; no gradient."""
    group = axis_group(group)
    n = dist.get_world_size(group)
    src = x.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's 1/n of ``x`` along ``dim`` (n ranks of ``group``, which
    divide it), summed over the group; no gradient."""
    group = axis_group(group)
    n = dist.get_world_size(group)
    src = x.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def _rows(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's 1/n of ``x`` along ``dim``, a copy."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


class _SeqGather(torch.autograd.Function):
    """All-gather along ``dim``.  Backward: the gradient reduce-scattered
    (``summed``: each rank's gradient of the gathered tensor is a part of
    it) or the rank's rows of it (each rank's is the whole, the same)."""

    @staticmethod
    def forward(ctx, x, dim, group, summed):
        ctx.dim, ctx.group, ctx.summed = dim, group, summed
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None, None
        return _rows(g, ctx.dim, ctx.group), None, None, None


class _SeqScatter(torch.autograd.Function):
    """This rank's rows along ``dim`` of ``x`` summed over ``group``
    (``summed``) or of ``x`` itself (the same on every rank).  Backward:
    the rows' gradients all-gathered.  The sum is ``psum``'s all-reduce,
    cut to the rank's rows, so that a layer's output holds the same values,
    rounding included, with Megatron-SP as without it: a bf16
    reduce-scatter sums in another order, which moved tiny hymba's and
    qwen2's bf16 gradients past the per-leaf gate the unsplit stream meets
    (``tests/test_torch_tp_seq.py``).  It moves twice a reduce-scatter's
    bytes (``PERF.md``)."""

    @staticmethod
    def forward(ctx, x, dim, group, summed):
        ctx.dim, ctx.group = dim, group
        if not summed:
            return _rows(x, dim, group)
        total = x.detach().clone()
        dist.all_reduce(total, group=group)
        return _rows(total, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None, None


def region_in(x: torch.Tensor, group) -> torch.Tensor:
    """The input (B, S, d) of a tensor-parallel region over ``group`` (the
    "model" group; None: the module runs whole on every rank).  Without
    SP: ``sum_grads`` over ``group`` (nothing for None).  Under
    ``use_seq_shard``: ``x`` is this rank's rows, gathered along the
    sequence over "model"; the gradient reduce-scattered (a group) or
    the rank's rows taken (None)."""
    if seq_sharded():
        g = axis_group(group) if group is not None else model_group()
        return _SeqGather.apply(x, 1, g, group is not None)
    return x if group is None else sum_grads(x, group)


def region_out(y: torch.Tensor, group) -> torch.Tensor:
    """The output (B, S, d) of a region: without SP ``psum`` over
    ``group``'s partial products (nothing for None); under
    ``use_seq_shard`` this rank's rows of their sum (``psum``'s, cut) or,
    for None, of ``y`` itself; the gradient all-gathered."""
    if seq_sharded():
        g = axis_group(group) if group is not None else model_group()
        return _SeqScatter.apply(y, 1, g, group is not None)
    return y if group is None else psum(y, group)


def seq_partial(w: torch.Tensor) -> torch.Tensor:
    """A replicated leaf that the layer applies to this rank's rows of a
    sequence-sharded stream (a norm's scale): under ``use_seq_shard`` its
    gradient is summed over "model" (each rank's covers its rows); else
    ``w`` as it is."""
    return sum_grads(w, model_group()) if seq_sharded() else w
