"""Mixture-of-Experts layer — sort-based local dispatch into a static
per-expert capacity, then the grouped SwiGLU expert FFN.

The reference's design (its ``models/moe.py``): each token's router picks
its top-k experts; the (token, choice) pairs are stably sorted by expert,
and each expert keeps the first ``capacity`` of its pairs in that order —
later ones are dropped — so dispatch costs O(tokens·k·d) gathers instead of
a dense one-hot einsum.  ``moe_local`` runs the experts
``[e_off, e_off + num_local)``; pairs routed elsewhere go to a dustbin id
``num_local``, which is how the expert-parallel path (one expert range
per shard, outputs summed over shards) is built on it.  ``moe_local`` takes
the shard's experts only, as the reference's ``shard_map`` body hands them
over; ``MoE.moe_local`` slices them from the layer's full set.
``moe_block`` under a mesh with a "model" axis is that body, one process
per rank on ``torch.distributed`` (``distributed.collectives.psum`` for
the sum); without one it is ``MoE.forward``, all experts.

Everything here is PyTorch's own ops (matmul, sort, gathers, ``bmm``), as
the reference computes it with ``jnp`` ops outside any Pallas kernel.  The
four stages run under ``tracing.span`` ranges
(``moe.router``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``), so a
trace attributes the device time of each.  Three choices keep the two
packages equal:

* top-k comes from a *stable* descending sort, so equal probabilities
  pick the lower expert id first, as ``jax.lax.top_k`` does
  (``torch.topk`` gives no such guarantee);
* the dispatch sort is stable, so each expert keeps the reference's
  tokens when its capacity binds;
* the combine puts each kept contribution back at its (token, choice)
  place through the inverse of the sort and sums the k choices in choice
  order in float32 — no ``index_add_``, whose CUDA form sums a token's
  contributions in a different order on every run.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..tracing import span
from .config import ArchConfig
from .layers import MLP, Init, _dtype

F32 = torch.float32


def capacity_for(tokens: int, cfg: ArchConfig) -> int:
    c = int(math.ceil(tokens * cfg.experts_per_token
                      * cfg.moe_capacity_factor / cfg.num_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8 (sublane grain)


def route(x: torch.Tensor, router: torch.Tensor, k: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Router of tokens ``x`` (T, d): f32 logits, softmax, the top ``k``
    probabilities renormalised to sum 1.  Returns (weights (T, k) f32,
    expert ids (T, k)); ties pick the lower id first."""
    probs = torch.softmax(x.to(F32) @ router, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    return top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9), top_i


def _count(ids: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of ``0 .. n - 1`` occurs in ``ids`` (all of them in
    range): ``bincount`` with an output length that does not depend on the
    values, so fake tensors (``launch.dryrun``) can trace it."""
    return torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def dispatch(top_i: torch.Tensor, *, e_off: int, num_local: int,
             capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Where each (token, choice) pair of ``top_i`` (T, k) lands among the
    local experts' ``capacity`` slots.  Returns (slot (T, k), keep (T, k)):
    a kept pair sits at row ``slot`` of the (num_local * capacity) expert
    buffer; a pair that is dropped (its expert is full) or not local has
    ``keep`` False and ``slot`` 0."""
    eid = top_i.reshape(-1)
    local = (eid >= e_off) & (eid < e_off + num_local)
    # dustbin id = num_local for non-local pairs
    eid_l = torch.where(local, eid - e_off, num_local)
    eid_s, order = torch.sort(eid_l, stable=True)
    counts = _count(eid_s, num_local + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(eid_s.numel(), device=eid.device) - starts[eid_s]
    keep_s = (pos < capacity) & (eid_s < num_local)
    slot_s = torch.where(keep_s, eid_s * capacity + pos, 0)
    # back to (token, choice) order through the inverse of the sort: each
    # sorted position is written once, so these scatters have no duplicates
    slot = torch.empty_like(slot_s)
    slot[order] = slot_s
    keep = torch.empty_like(keep_s)
    keep[order] = keep_s
    return slot.view_as(top_i), keep.view_as(top_i)


def moe_local(p: dict, x: torch.Tensor, cfg: ArchConfig, *, e_off: int,
              num_local: int, capacity: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard MoE FFN.  x: (T, d) local tokens; ``p`` holds the
    ``router`` (d, E) and the experts ``[e_off, e_off + num_local)`` only
    (``w_in``, ``w_gate`` (n, d, ff), ``w_out`` (n, ff, d)), as the body of
    the reference's expert-parallel path hands them over.  Returns (partial
    output (T, d) in x's dtype, the number of (token, choice) pairs routed
    to each of the E experts, f32 — the reference's load-balancing
    statistics)."""
    T, d = x.shape
    k, C = cfg.experts_per_token, capacity
    with span("moe.router"):
        top_w, top_i = route(x, p["router"], k)
    with span("moe.dispatch"):
        slot, keep = dispatch(top_i, e_off=e_off, num_local=num_local,
                              capacity=C)
        # Scatter into the (num_local + 1, C) slot table the id of the
        # token each slot holds (T: an empty slot, which gathers a zero
        # row).  Kept slots are unique; every dropped or non-local pair
        # writes the dustbin row's slot 0 (index num_local * C), where
        # duplicates are harmless because that row is thrown away.
        table = torch.full(((num_local + 1) * C,), T, dtype=torch.long,
                           device=x.device)
        tok = torch.arange(T, device=x.device).repeat_interleave(k)
        table[torch.where(keep.reshape(-1), slot.reshape(-1),
                          num_local * C)] = tok
        xpad = torch.cat([x, x.new_zeros((1, d))])
        xe = xpad[table[:num_local * C]].view(num_local, C, d)
    with span("moe.experts"):
        h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_in"])
        y = torch.bmm(h, p["w_out"]).view(num_local * C, d)    # (n*C, d)
    with span("moe.combine"):
        # A dropped or non-local pair gets weight 0: its slot 0 holds a
        # kept token's row of y or an empty slot's zero row, both finite,
        # so it adds exactly 0 (the reference masks the product instead).
        # One (T, d) gather, cast and fused multiply-add per choice, in
        # choice order, in float32.
        w = torch.where(keep, top_w, 0.0)
        out = torch.zeros((T, d), dtype=F32, device=x.device)
        for j in range(k):
            out.addcmul_(y[slot[:, j]].to(F32), w[:, j, None])
        counts = _count(top_i.reshape(-1), cfg.num_experts).to(F32)
        return out.to(x.dtype), counts


class MoE(nn.Module):
    """The MoE FFN of one layer: ``router`` (d, E) in float32, ``w_in`` and
    ``w_gate`` (E, d, ff) and ``w_out`` (E, ff, d) in the config's dtype,
    and, where the config has one, an always-on ``shared`` expert
    (a SwiGLU ``MLP`` of width ``shared_expert_ff``)."""

    expert_leaves = ("w_in", "w_gate", "w_out")
    # the dim each leaf keeps sharded over "model" under a mesh
    # (``distributed.sharding.gathered``): the experts
    model_dims = dict.fromkeys(expert_leaves, 0)

    def __init__(self, cfg: ArchConfig, init: Init):
        super().__init__()
        dt = _dtype(cfg)
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        out_sc = 0.02 / math.sqrt(2 * cfg.num_layers)
        self.cfg = cfg
        self.router = init.normal((d, E), 0.02, F32)  # router kept in f32
        self.w_in = init.normal((E, d, ff), 0.02, dt)
        self.w_gate = init.normal((E, d, ff), 0.02, dt)
        self.w_out = init.normal((E, ff, d), out_sc, dt)
        if cfg.shared_expert_ff:
            self.shared = MLP(cfg, init, d_ff=cfg.shared_expert_ff)

    def moe_local(self, x: torch.Tensor, *, e_off: int, num_local: int,
                  capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``moe_local`` of this layer's experts ``[e_off, e_off +
        num_local)``, sliced from its full set, over tokens ``x`` (T, d)."""
        return moe_local(self.weights(e_off, num_local), x, self.cfg,
                         e_off=e_off, num_local=num_local, capacity=capacity)

    def weights(self, e_off: int, num_local: int) -> dict:
        """The router and experts ``[e_off, e_off + num_local)`` of the
        weights this layer holds (its full set, or, under the expert-
        parallel path, its shard's own ``num_local``)."""
        ws = {"router": self.router}
        for name in self.expert_leaves:
            w = getattr(self, name)
            ws[name] = (w[e_off:e_off + num_local]
                        if w.shape[0] == self.cfg.num_experts else w)
        return ws

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, d) -> (B, S, d) over all experts, capacity from B·S."""
        B, S, d = x.shape
        E = self.cfg.num_experts
        out, _ = self.moe_local(x.reshape(B * S, d), e_off=0, num_local=E,
                                capacity=capacity_for(B * S, self.cfg))
        out = out.view(B, S, d)
        if self.cfg.shared_expert_ff:
            out = out + self.shared(x)
        return out


def moe_block(moe: MoE, x: torch.Tensor, cfg: ArchConfig, mesh=None,
              batch_axes: tuple = ("data",), model_axis: str = "model"
              ) -> torch.Tensor:
    """(B, S, d) -> (B, S, d).  With no mesh, or a mesh without
    ``model_axis``, ``moe(x)``.  Under a mesh, the body of the reference's
    ``shard_map``: ``x`` is this rank's batch shard (B = the global batch
    / the batch axes' size), this rank runs experts ``[e_off, e_off +
    num_local)`` of its ``model_axis`` coordinate with a capacity from its
    own tokens, and the partial outputs (in x's dtype) are summed over
    ``model_axis``; the shared expert (an ``MLP``, tensor-parallel over
    "model" where its columns divide it) is added after.  ``moe``'s expert
    leaves are the shard's own (``shard_params`` places them so, and a
    ``Block`` gathers them over "data" only) or the full set, which is
    sliced here.  E not divisible by the axis size drops the experts
    beyond ``n_model * num_local``, as the reference does.
    ``batch_axes`` names the axes the batch is sharded over, as in the
    reference, whose capacity reads the global batch over their size;
    here ``x`` already is that shard, so the capacity reads its rows.
    Under Megatron-SP (``context.use_seq_shard``) ``x`` and the output are
    this rank's rows of the sequence, gathered before the router and cut
    to the rank's rows after the sum (``collectives.region_in``,
    ``region_out``)."""
    from ..distributed.collectives import region_in, region_out, sum_grads
    from ..distributed.context import axis_names, axis_size

    if mesh is None or model_axis not in axis_names(mesh):
        return moe(x)
    group = mesh.get_group(model_axis)
    # under Megatron-SP x is this rank's rows of the sequence: gathered
    # first, so that the capacity reads every token, as without SP
    xg = region_in(x, group)
    B, S, d = xg.shape
    E = cfg.num_experts
    n_model = axis_size(mesh, model_axis)
    num_local = max(E // n_model, 1)
    # the reference's t_local = ceil(B_global / n_data) * S: this shard's
    cap = capacity_for(max(B * S, 1), cfg)
    e_off = mesh.get_local_rank(model_axis) * num_local
    p = moe.weights(e_off, num_local)
    # x and the router are the same on every rank of the model axis, and
    # each rank's experts use them differently: their gradients sum over it
    # (x's in ``region_in``)
    p["router"] = sum_grads(p["router"], group)
    out, _ = moe_local(p, xg.reshape(B * S, d), cfg, e_off=e_off,
                       num_local=num_local, capacity=cap)
    out = region_out(out.view(B, S, d), group)
    if cfg.shared_expert_ff:
        out = out + moe.shared(x)
    return out
