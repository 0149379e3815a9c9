"""Optimizers — AdamW (dtype-configurable states) and Adafactor-style
factored second moment for the largest models, plus global-norm clipping and
LR schedules, with the reference's math (``training/optim.py``).

The reference's ``init`` / ``update`` over a tree of arrays is kept, over
dicts of tensors, rather than ``torch.optim.Optimizer``: the training state
is one tree ``{"params", "opt"}`` that the checkpoint store and the
fault-tolerant runner carry leaf for leaf as the reference's does, and
``torch.optim``'s ``state_dict`` keys states by parameter index and keeps
the schedule (a callable) in its param groups, which an ``.npy`` store cannot
hold.  Unlike the reference, ``update`` works in place: it writes the new
parameters into the tensors it was given (so a module's parameters move with
them) and the new moments into the state's tensors, and returns those same
objects.  Arithmetic is float32 throughout; states are stored in
``state_dtype``.  AdamW updates a plain leaf of more than ``BLOCK``
elements a block of rows at a time: the update is elementwise, so the
result is the same to the bit, and its float32 temporaries stay a block's
size (a dbrx-132B expert leaf is 1.06e9 elements, 4.2 GB in float32 for
each temporary).

The reference stacks each layer's leaves over the layers, so a per-layer
norm scale (d,) of the port is a row of an (L, d) leaf there.  Both
optimizers decide by that stacked rank (``models.convert.reference_leaf``):
AdamW decays every layer leaf, and FactoredAdam factors the 1-D leaves of
one stack together, one "vr" (L,) / "vc" (d,) pair per stack kept under the
stack's reference name (``layers.ln1.scale``; llama4's
``layers.s{i}.ln1.scale``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate

from ..models.convert import reference_leaf

F32 = torch.float32
BLOCK = 1 << 26       # elements of AdamW's update of a plain leaf at a time


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[torch.Tensor],
                                                    torch.Tensor]:
    def lr(step):
        step = torch.as_tensor(step).to(F32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor in a (nested) dict, in
    float32."""
    return torch.sqrt(sum(torch.sum(t.to(F32) ** 2) for t in _leaves(tree)))


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _device(params: dict) -> torch.device:
    return next(iter(params.values())).device


def _stacked_dim(name: str, p: torch.Tensor) -> int:
    """The rank of parameter ``name`` in the reference, whose layer leaves
    are stacked over the layers."""
    return p.dim() + (reference_leaf(name)[1] is not None)


def _broadcast_to(x: torch.Tensor, like: torch.Tensor,
                  dim: int) -> torch.Tensor:
    """``x``, a factor of ``like``'s shape with size 1 along ``dim``, placed
    so that ``x * like`` is local: sharded as ``like`` on every mesh
    dimension where ``like`` is sharded along another dimension, replicated
    elsewhere.  A mesh dimension whose placement changes passes through
    ``Replicate`` (an all-gather of the factor, then a local slice), never
    a shard-to-shard exchange, which is an all-to-all on a ``cuda`` mesh and
    an all-gather on a ``cpu`` one (gloo has no all-to-all).  Without it
    ``DTensor`` reshards the parameter-sized product instead."""
    if not isinstance(like, DTensor) or not isinstance(x, DTensor):
        return x
    dim %= like.dim()
    want = [pl if pl.is_shard() and pl.dim != dim else Replicate()
            for pl in like.placements]
    mid = [Replicate() if pl.is_shard() and pl != w else pl
           for pl, w in zip(x.placements, want)]
    if mid != list(x.placements):
        x = x.redistribute(x.device_mesh, mid)
    return x.redistribute(x.device_mesh, want)


def _row_blocks(*leaves: torch.Tensor) -> list[tuple]:
    """``leaves`` (of one shape) in blocks of whole rows of at most
    ``BLOCK`` elements, as views; a ``DTensor``, a 0-d or a smaller leaf
    is one block of the leaves themselves."""
    p = leaves[0]
    if isinstance(p, DTensor) or p.dim() == 0 or p.numel() <= BLOCK:
        return [leaves]
    rows = max(1, BLOCK // (p.numel() // p.shape[0]))
    return [tuple(t[i:i + rows] for t in leaves)
            for i in range(0, p.shape[0], rows)]


def _grad(g, p: torch.Tensor) -> torch.Tensor:
    """A leaf's gradient; ``None`` (the leaf did not reach the loss) is a
    zero gradient, as ``jax.grad`` returns."""
    return torch.zeros_like(p) if g is None else g


class _Optimizer:
    learning_rate: Callable | float
    clip_norm: float

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return torch.tensor(self.learning_rate, dtype=F32,
                            device=step.device)

    def _clip(self, grads: dict, params: dict):
        grads = {k: _grad(grads.get(k), p) for k, p in params.items()}
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        return grads, gnorm, scale


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamW(_Optimizer):
    learning_rate: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: torch.dtype = F32   # bf16 halves optimizer memory

    def init(self, params: dict) -> dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.state_dtype,
                               device=p.device)
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_device(params)),
                "m": {k: zeros(p) for k, p in params.items()},
                "v": {k: zeros(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        """One step: clip by the global norm of all grads, Adam moments in
        f32, bias correction at the new step, decoupled weight decay on
        leaves whose stacked rank is >= 2 (every layer leaf), lr =
        schedule(new step).  Returns
        ``(params, state, {"grad_norm", "lr"})``, updated in place."""
        step = state["step"] + 1
        grads, gnorm, scale = self._clip(grads, params)
        lr = self._lr(step)
        b1, b2 = self.b1, self.b2
        stepf = step.to(F32)
        bc1 = 1 - torch.tensor(b1, dtype=F32, device=step.device) ** stepf
        bc2 = 1 - torch.tensor(b2, dtype=F32, device=step.device) ** stepf
        for k, leaf in params.items():
            decay = _stacked_dim(k, leaf) >= 2   # decoupled, matrices only
            for p, m, v, g in _row_blocks(leaf, state["m"][k],
                                          state["v"][k], grads[k]):
                g = g.to(F32) * scale
                m_new = b1 * m.to(F32) + (1 - b1) * g
                v_new = b2 * v.to(F32) + (1 - b2) * g * g
                mh = m_new / bc1
                vh = v_new / bc2
                delta = mh / (torch.sqrt(vh) + self.eps)
                if decay:
                    delta = delta + self.weight_decay * p.to(F32)
                p.copy_((p.to(F32) - lr * delta).to(p.dtype))
                m.copy_(m_new.to(self.state_dtype))
                v.copy_(v_new.to(self.state_dtype))
        state["step"].copy_(step)
        return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Adafactor-style factored second moment (for the 400B-class archs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FactoredAdam(_Optimizer):
    """First moment in bf16, second moment factored over the two largest
    dims of >=2D params (O(n+m) instead of O(nm) memory), ranks as the
    reference stacks them: the 1-D leaves of one stack share a "vr"/"vc"
    pair.  ``layer_groups`` (required, keyword): the sub-layers of a group
    of layers, each stacked on its own (``models.convert.layer_groups(cfg)``;
    llama4's 2, 1 for every other configuration and for a tree that holds
    no layers)."""
    learning_rate: Callable | float = 3e-4
    b1: float = 0.9
    decay: float = 0.99
    eps: float = 1e-30
    clip_norm: float = 1.0
    weight_decay: float = 0.0
    layer_groups: int = dataclasses.field(kw_only=True)

    def _stacks(self, params: dict) -> dict[str, list[str]]:
        """The 1-D layer leaves by the reference's stacked leaf, in row
        order."""
        rows: dict[str, dict[int, str]] = {}
        for k, p in params.items():
            ref, row = reference_leaf(k, self.layer_groups)
            if row is not None and p.dim() == 1:
                rows.setdefault(ref, {})[row] = k
        return {ref: [by_row[i] for i in sorted(by_row)]
                for ref, by_row in rows.items()}

    def init(self, params: dict) -> dict:
        def second(p):
            if p.dim() < 2:
                return {"v": torch.zeros(p.shape, dtype=F32, device=p.device)}
            return {"vr": torch.zeros(p.shape[:-1], dtype=F32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=F32, device=p.device)}
        stacks = self._stacks(params)
        stacked = {k for names in stacks.values() for k in names}
        v = {k: second(p) for k, p in params.items() if k not in stacked}
        for ref, names in stacks.items():
            p = params[names[0]]
            v[ref] = {"vr": torch.zeros((len(names),), dtype=F32,
                                        device=p.device),
                      "vc": torch.zeros(p.shape, dtype=F32, device=p.device)}
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_device(params)),
                "m": {k: torch.zeros(p.shape, dtype=torch.bfloat16,
                                     device=p.device)
                      for k, p in params.items()},
                "v": v}

    def _factored(self, v: dict, g2: torch.Tensor) -> torch.Tensor:
        """Update ``v``'s "vr"/"vc" from the squared gradient ``g2`` in
        place; returns the preconditioner, placed as ``g2``."""
        d = self.decay
        vr = d * v["vr"] + (1 - d) * g2.mean(dim=-1)
        vc = d * v["vc"] + (1 - d) * g2.mean(dim=-2)
        v["vr"].copy_(vr)
        v["vc"].copy_(vc)
        rfac = torch.rsqrt(vr / torch.clamp(vr.mean(dim=-1, keepdim=True),
                                            min=self.eps))
        return (_broadcast_to(rfac[..., None], g2, -1)
                * _broadcast_to(torch.rsqrt(vc)[..., None, :], g2, -2))

    def _step(self, p, m, g, precond, lr, decay: bool) -> None:
        m_new = self.b1 * m.to(F32) + (1 - self.b1) * g
        delta = m_new * precond
        if decay and self.weight_decay:
            delta = delta + self.weight_decay * p.to(F32)
        p.copy_((p.to(F32) - lr * delta).to(p.dtype))
        m.copy_(m_new.to(torch.bfloat16))

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        """One step, in place, as ``AdamW.update``."""
        step = state["step"] + 1
        grads, gnorm, scale = self._clip(grads, params)
        lr = self._lr(step)
        d = self.decay
        stacks = self._stacks(params)
        stacked = {k for names in stacks.values() for k in names}
        for k, p in params.items():
            if k in stacked:
                continue
            v = state["v"][k]
            g = grads[k].to(F32) * scale
            g2 = g * g + self.eps
            if p.dim() < 2:
                v["v"].copy_(d * v["v"] + (1 - d) * g2)
                precond = torch.rsqrt(v["v"])
            else:
                precond = self._factored(v, g2)
            self._step(p, state["m"][k], g, precond, lr,
                       _stacked_dim(k, p) >= 2)
        for ref, names in stacks.items():
            gs = [grads[k].to(F32) * scale for k in names]
            g = torch.stack(gs)
            precond = self._factored(state["v"][ref], g * g + self.eps)
            for i, k in enumerate(names):
                self._step(params[k], state["m"][k], gs[i], precond[i], lr,
                           True)
        state["step"].copy_(step)
        return params, state, {"grad_norm": gnorm, "lr": lr}
