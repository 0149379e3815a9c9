"""Model layers as PyTorch modules.

Each module holds its parameters under the reference's names (``wq``,
``wk``, ``ln1.scale``, ...), so a module's ``state_dict`` key is the path of
the same leaf in the reference's parameter tree (``models.convert``).

Attention comes in three executable forms:
* prefill: ``kernels.flash_attention`` (K2) over the whole prompt — the
  hand-written CUDA kernel on the card, its plain version on the CPU;
* ``decode_attention`` — one query step against a (possibly windowed)
  cache, eager torch;
* MLA variants (latent-compressed KV, absorbed-matmul decode), whose
  prefill also goes through K2.

Under a mesh (``distributed.context.use_mesh``) the layers compute on
this rank's batch shard, with the residual stream replicated over "model".
Attention and the dense MLP are tensor-parallel there, as the reference's
sharding makes XLA compute them (Megatron's column/row split): where the
heads (the MLP's columns) divide the "model" axis, a rank holds its share
of ``wq``, ``wo`` and the biases (``wi``, ``wg``, ``wo``) through the call
(``model_dims``; ``distributed.sharding.gathered``), computes its own
heads (columns) and sums the output projection's partial products over
"model" (``distributed.collectives.psum``, in the activations' dtype, as
the reference's ``einsum`` gives them).  The replicated input of the
column-parallel products goes through ``sum_grads``, whose backward sums
its gradient over "model".  The KV heads follow the query heads
(``HeadShard``): where they divide the axis, ``wk``/``wv`` are sharded as
``wq``; where they do not (KH < n), the rank gathers them whole, keeps the
KV heads its query heads read (their gradient summed over "model") and,
where those heads do not give each KV head the same number of query heads,
repeats K/V once per local query head so that K2 sees a uniform GQA
ratio.  Prefill and training run K2 and K2-bwd on the local heads only; a
decode step writes and reads the cache heads of the rank's own query
heads, which ``Model.init_cache`` allocates per rank.  MLA is
tensor-parallel where its heads divide the axis: a rank keeps its heads'
share of ``wq_b``, ``wk_b``, ``wv_b`` and ``wo``, computes the down
projections and the latent (``wq_a``, ``wkv_a``, both norms: gathered)
whole, and runs K2 / K2-bwd (prefill) or the absorbed decode against the
whole latent cache on its own heads; the latent's and the query latent's
gradients are summed over "model", and ``wo``'s product too.  The latent
cache stays whole on every rank, as the reference's is replicated over
"model".  The SSM's tensor-parallel form is ``models.ssm``'s; its gated
norm over a split d_inner is ``rmsnorm_split``.  Each module enters and
leaves its region through ``collectives.region_in`` / ``region_out``:
without Megatron-SP these are the ``sum_grads`` and ``psum`` above; under
it (``context.use_seq_shard``, the training path only) the module's input
is this rank's rows of the sequence, gathered on the way in, and its
output is summed back to those rows on the way out.  A module that runs
whole passes no group: under SP it gathers the rows and keeps its own
rows of the output, with gradients that keep every rank's leaves whole.
MLA computes its down projections and latents whole on every rank (their
gradients summed by ``_shared``), so its input enters as a whole
module's.  The reference's
``constrain`` calls on the decode queries stand where its do, and leave a
plain tensor as it is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.nn import functional as F

from ..distributed.collectives import (psum, region_in, region_out,
                                       sum_grads)
from ..distributed.context import (constrain, current_mesh, model_axis_size,
                                   model_group, model_rank)
from ..kernels import flash_attention
from .config import ArchConfig

F32 = torch.float32
NEG_INF = -1e30


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class Init:
    """Where and how a model's parameters are drawn: scaled standard normals
    from one ``torch.Generator`` on one device."""

    def __init__(self, device: torch.device, generator: torch.Generator):
        self.device = device
        self.generator = generator

    def normal(self, shape, scale: float, dtype: torch.dtype) -> nn.Parameter:
        if self.device.type == "meta":           # shapes only, no draws
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=self.device),
                                requires_grad=False)
        x = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=F32)
        return nn.Parameter((scale * x).to(dtype), requires_grad=False)

    def const(self, x: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(x.to(self.device), requires_grad=False)


def _linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Contract x's last dim with w's first: ``einsum("...d,d...->...")``."""
    out = x @ w.reshape(w.shape[0], -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    h = x.float()
    var = (h * h).mean(dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * scale.float()).to(x.dtype)


def rmsnorm_split(scale: torch.Tensor, x: torch.Tensor, eps: float,
                  dim: int, group: Any) -> torch.Tensor:
    """``rmsnorm`` over a last dim of ``dim`` elements split over ``group``
    (the SSM's gated norm over d_inner under a tensor-parallel mesh): ``x``
    and ``scale`` hold this rank's slice of it.  Each rank's float32 sum of
    squares is summed over the group (``psum``, in float32) and divided by
    the whole ``dim``; every rank's slice reads that sum, so its gradient
    is summed over the group too (``sum_grads``)."""
    h = x.float()
    ss = sum_grads(psum((h * h).sum(dim=-1, keepdim=True), group), group)
    h = h * torch.rsqrt(ss / dim + eps)
    return (h * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, init: Init):
        super().__init__()
        self.scale = init.const(torch.ones((d,), dtype=dtype))

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return rmsnorm(self.scale, x, eps)


# ---------------------------------------------------------------------------
# Rotary position embedding (llama-style half rotation)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=F32, device=device)
                            / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # (D/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                         # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Decode attention (eager torch; prefill goes through K2)
# ---------------------------------------------------------------------------


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int, *, window: int = 0,
                     scale: float | None = None) -> torch.Tensor:
    """One decode step.  q: (B, 1, H, Dk); caches: (B, S, KH, D*) — under
    a tensor-parallel mesh, this rank's query and cache heads.

    ``length`` = number of valid cache entries (the new token's K/V must
    already be written).  Masked full-cache attention — O(S) per step.
    """
    B, _, H, Dk = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    if scale is None:
        scale = 1.0 / math.sqrt(Dk)
    qg = q.reshape(B, KH, G, Dk)
    # Match q's sharding to the cache (KH or head_dim over "model"), as the
    # reference does (a layout hint; a plain tensor stays as it is).
    mesh = current_mesh()
    if mesh is not None and "model" in (mesh.mesh_dim_names or ()):
        n = model_axis_size(mesh)
        if KH % n == 0 and KH >= n:
            qg = constrain(qg, None, "model", None, None)
        elif Dk % n == 0:
            qg = constrain(qg, None, None, None, "model")
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    mask = pos < length
    if window > 0:
        mask &= pos >= length - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, -1).to(q.dtype)


# ---------------------------------------------------------------------------
# Standard GQA attention (covers MHA as KH == H)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HeadShard:
    """One rank's share of an attention layer's heads over a "model" axis:
    query heads ``[h0, h0 + hl)``, the KV heads ``[kv0, kv1)`` they read,
    and, where those KV heads do not each serve the same number of them,
    ``expand``: each local query head's KV head less ``kv0``."""
    group: Any
    h0: int
    hl: int
    kv0: int
    kv1: int
    expand: tuple[int, ...] | None


def split_heads(heads: int, kv_heads: int, n: int, rank: int,
                group: Any = None) -> HeadShard:
    """Rank ``rank``'s share of ``heads`` heads over ``n`` ranks (n divides
    them), head h reading KV head h // (heads / kv_heads): attention's
    query and KV heads, MLA's heads (each its own), or the SSM's heads and
    the B/C groups they read."""
    G = heads // kv_heads
    hl = heads // n
    h0 = rank * hl
    kv = [h // G for h in range(h0, h0 + hl)]
    kv0, kv1 = kv[0], kv[-1] + 1
    uniform = len({kv.count(j) for j in range(kv0, kv1)}) == 1
    return HeadShard(group, h0, hl, kv0, kv1,
                     None if uniform else tuple(j - kv0 for j in kv))


def head_shard(cfg: ArchConfig, n: int, rank: int,
               group: Any = None) -> HeadShard:
    """Rank ``rank``'s heads of ``cfg``'s attention over ``n`` ranks (n
    divides the query heads)."""
    return split_heads(cfg.num_heads, cfg.num_kv_heads, n, rank, group)


def local_heads(w: torch.Tensor, dim: int, heads: int, kv_heads: int
                ) -> HeadShard | None:
    """This rank's heads where ``w`` (a leaf whose dim ``dim`` holds the
    ``heads`` heads, as a call sees it, or outside one its shard) holds a
    "model" share of them under the installed mesh; None where it holds
    them all (no mesh, a "model" axis of one rank, heads that do not
    divide it)."""
    mesh = current_mesh()
    if model_axis_size(mesh) == 1:
        return None
    local = (w.to_local() if isinstance(w, DTensor) else w).shape[dim]
    if local == heads:
        return None
    return split_heads(heads, kv_heads, heads // local, model_rank(mesh),
                       model_group(mesh))


class Attention(nn.Module):
    # the dim each leaf keeps sharded over "model" under a mesh
    # (``distributed.sharding.gathered``): the heads
    model_dims = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0,
                  "bv": 0}

    def __init__(self, cfg: ArchConfig, init: Init):
        super().__init__()
        dt = _dtype(cfg)
        d, H, KH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        out_sc = 0.02 / math.sqrt(2 * cfg.num_layers)
        self.cfg = cfg
        self.wq = init.normal((d, H, hd), 0.02, dt)
        self.wk = init.normal((d, KH, hd), 0.02, dt)
        self.wv = init.normal((d, KH, hd), 0.02, dt)
        self.wo = init.normal((H, hd, d), out_sc, dt)
        if cfg.qkv_bias:
            self.bq = init.const(torch.zeros((H, hd), dtype=dt))
            self.bk = init.const(torch.zeros((KH, hd), dtype=dt))
            self.bv = init.const(torch.zeros((KH, hd), dtype=dt))

    def head_shard(self) -> HeadShard | None:
        """This rank's heads, or None where ``wq`` holds them all (no
        mesh, a "model" axis of one rank, or heads that do not divide it).
        Read from ``wq`` as a call sees it (a layer gathers its leaves for
        the call) or, outside one, from its shard."""
        return local_heads(self.wq, 1, self.cfg.num_heads,
                           self.cfg.num_kv_heads)

    def _kv(self, w: torch.Tensor, dim: int,
            sh: HeadShard | None) -> torch.Tensor:
        """``w`` (``wk``, ``wv`` or a bias) as this rank uses it: the KV
        heads ``sh`` reads from a leaf gathered whole, whose gradient then
        sums over "model"; a "model" shard as it is."""
        if sh is None or w.shape[dim] != self.cfg.num_kv_heads:
            return w
        return sum_grads(w, sh.group).narrow(dim, sh.kv0, sh.kv1 - sh.kv0)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor,
            sh: HeadShard | None = None):
        q = _linear(x, self.wq)
        k = _linear(x, self._kv(self.wk, 1, sh))
        v = _linear(x, self._kv(self.wv, 1, sh))
        if self.cfg.qkv_bias:
            q = q + self.bq
            k = k + self._kv(self.bk, 0, sh)
            v = v + self._kv(self.bv, 0, sh)
        q = apply_rope(q, positions, self.cfg.rope_theta)
        k = apply_rope(k, positions, self.cfg.rope_theta)
        return q, k, v

    @staticmethod
    def _per_query(sh: HeadShard | None, k: torch.Tensor,
                   v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """K and V (..., heads, D) repeated once per local query head where
        the rank's query heads split its KV heads unevenly."""
        if sh is None or sh.expand is None:
            return k, v
        idx = torch.tensor(sh.expand, device=k.device)
        return k.index_select(-2, idx), v.index_select(-2, idx)

    def _out(self, o: torch.Tensor, sh: HeadShard | None) -> torch.Tensor:
        """The output projection of ``o`` (B, S, heads, hd); under ``sh`` a
        row-parallel product summed over "model" (``region_out``)."""
        out = _linear(o.flatten(-2), self.wo.flatten(0, 1))
        return region_out(out, None if sh is None else sh.group)

    def forward(self, x: torch.Tensor, *, window: int = 0):
        """Full-sequence (prefill) attention; returns (out, {"k", "v"}),
        K/V of this rank's KV heads under a tensor-parallel mesh.  Under
        Megatron-SP ``x`` and the output are this rank's rows of the
        sequence (``region_in``, ``region_out``)."""
        sh = self.head_shard()
        x = region_in(x, None if sh is None else sh.group)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        q, k, v = self.qkv(x, positions, sh)
        o = flash_attention(q, *self._per_query(sh, k, v), causal=True,
                            window=window)
        return self._out(o, sh), {"k": k, "v": v}

    def decode(self, x: torch.Tensor, cache: dict, pos: int, *,
               window: int = 0) -> torch.Tensor:
        """x: (B, 1, d).  Writes this token's K/V into ``cache["k"]``,
        ``cache["v"]`` (B, S, KH, hd; this rank's KV heads under a
        tensor-parallel mesh) at ``pos``, in place; a ``pos`` past the end
        writes the last slot, as the reference's ``dynamic_update_slice``
        clamps its start."""
        positions = torch.full((x.shape[0], 1), pos, device=x.device)
        sh = self.head_shard()
        q, k, v = self.qkv(x, positions, sh)
        slot = min(pos, cache["k"].shape[1] - 1)
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        o = decode_attention(q, *self._per_query(sh, cache["k"], cache["v"]),
                             pos + 1, window=window)
        return self._out(o, sh)


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    # the dim each leaf keeps sharded over "model" under a mesh: the heads
    model_dims = {"wq_b": 1, "wk_b": 1, "wv_b": 1, "wo": 0}

    def __init__(self, cfg: ArchConfig, init: Init):
        super().__init__()
        dt = _dtype(cfg)
        d, H = cfg.d_model, cfg.num_heads
        nope, rope, vdim = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                            cfg.v_head_dim)
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        out_sc = 0.02 / math.sqrt(2 * cfg.num_layers)
        self.cfg = cfg
        self.wq_a = init.normal((d, qr), 0.02, dt)                 # down
        self.wq_b = init.normal((qr, H, nope + rope), 0.02, dt)    # up
        self.wkv_a = init.normal((d, kvr + rope), 0.02, dt)        # latent + rope key
        self.wk_b = init.normal((kvr, H, nope), 0.02, dt)
        self.wv_b = init.normal((kvr, H, vdim), 0.02, dt)
        self.wo = init.normal((H, vdim, d), out_sc, dt)
        self.q_norm = RMSNorm(qr, dt, init)
        self.kv_norm = RMSNorm(kvr, dt, init)

    def head_shard(self) -> HeadShard | None:
        """This rank's heads (each its own K/V head), or None where
        ``wq_b`` holds them all; read as ``Attention.head_shard``."""
        return local_heads(self.wq_b, 1, self.cfg.num_heads,
                           self.cfg.num_heads)

    @staticmethod
    def _shared(x: torch.Tensor, sh: HeadShard | None) -> torch.Tensor:
        """A tensor every rank computes whole and reads for its own heads
        only: under ``sh`` its gradient is summed over "model"."""
        return x if sh is None else sum_grads(x, sh.group)

    def _q(self, x, positions, sh: HeadShard | None = None):
        cfg = self.cfg
        nope = cfg.qk_nope_head_dim
        cq = self.q_norm(_linear(x, self.wq_a), cfg.norm_eps)
        q = _linear(self._shared(cq, sh), self.wq_b)
        q_nope, q_rope = q[..., :nope], q[..., nope:]
        return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)

    def _latent(self, x, positions):
        cfg = self.cfg
        kvr = cfg.kv_lora_rank
        kv = _linear(x, self.wkv_a)
        ckv = self.kv_norm(kv[..., :kvr], cfg.norm_eps)
        k_rope = apply_rope(kv[..., None, kvr:], positions, cfg.rope_theta)
        return ckv, k_rope[..., 0, :]

    def _out(self, o: torch.Tensor, sh: HeadShard | None) -> torch.Tensor:
        """``wo`` on ``o`` (B, S, heads, vdim); under ``sh`` row-parallel,
        summed over "model" (``region_out``)."""
        out = _linear(o.flatten(-2), self.wo.flatten(0, 1))
        return region_out(out, None if sh is None else sh.group)

    def forward(self, x: torch.Tensor, *, window: int = 0):
        """Prefill MLA: expand the latent to per-head K/V and attend through
        K2.  K per head = [W_kb·c ; k_rope (shared)]; V per head = W_vb·c.
        Under a tensor-parallel mesh the rank's heads only.  Returns (out,
        {"ckv", "krope"}), the latent whole.  Every rank computes the down
        projections and latents whole (their gradients summed by
        ``_shared``), so under Megatron-SP ``x`` enters as a whole
        module's input (``region_in(x, None)``)."""
        cfg = self.cfg
        x = region_in(x, None)
        B, S, _ = x.shape
        nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        positions = torch.arange(S, device=x.device)[None, :]
        sh = self.head_shard()
        q_nope, q_rope = self._q(x, positions, sh)
        ckv, k_rope = self._latent(x, positions)
        c = self._shared(ckv, sh)
        k_nope = _linear(c, self.wk_b)
        v = _linear(c, self.wv_b)
        H = k_nope.shape[-2]
        k = torch.cat([k_nope, self._shared(k_rope, sh)[:, :, None, :]
                       .expand(B, S, H, rope)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        o = flash_attention(q, k, v, causal=True,
                            scale=1.0 / math.sqrt(nope + rope))
        return self._out(o, sh), {"ckv": ckv, "krope": k_rope}

    def decode(self, x: torch.Tensor, cache: dict, pos: int, *,
               window: int = 0) -> torch.Tensor:
        """Absorbed-matmul MLA decode: score against the *latent* cache
        (``cache["ckv"]`` (B, S, kvr), ``cache["krope"]`` (B, S, rope),
        whole on every rank), written at ``min(pos, S - 1)`` in place, as in
        ``Attention.decode``; under a tensor-parallel mesh the rank's heads
        only."""
        cfg = self.cfg
        positions = torch.full((x.shape[0], 1), pos, device=x.device)
        sh = self.head_shard()
        q_nope, q_rope = self._q(x, positions)        # (B,1,H,nope/rope)
        ckv_t, k_rope_t = self._latent(x, positions)  # (B,1,kvr), (B,1,rope)
        ckv, kr = cache["ckv"], cache["krope"]
        slot = min(pos, ckv.shape[1] - 1)
        ckv[:, slot] = ckv_t[:, 0]
        kr[:, slot] = k_rope_t[:, 0]
        q_lat = torch.einsum("bqhe,rhe->bqhr", q_nope, self.wk_b)
        mesh = current_mesh()
        if (mesh is not None and "model" in (mesh.mesh_dim_names or ())
                and cfg.kv_lora_rank % model_axis_size(mesh) == 0):
            q_lat = constrain(q_lat, None, None, None, "model")
        s = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), ckv.float())
             + torch.einsum("bqhe,bse->bhqs", q_rope.float(), kr.float()))
        s = s * (1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))
        mask = torch.arange(ckv.shape[1], device=x.device) < pos + 1
        s = s.masked_fill(~mask, NEG_INF)
        pattn = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhqs,bsr->bqhr", pattn, ckv.float())
        o = torch.einsum("bqhr,rhe->bqhe", o_lat.to(x.dtype), self.wv_b)
        return self._out(o, sh)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    # the dim each leaf keeps sharded over "model" under a mesh: the columns
    model_dims = {"wi": 1, "wg": 1, "wo": 0}

    def __init__(self, cfg: ArchConfig, init: Init, d_ff: int | None = None):
        super().__init__()
        dt = _dtype(cfg)
        d, ff = cfg.d_model, d_ff or cfg.d_ff
        out_sc = 0.02 / math.sqrt(2 * cfg.num_layers)
        self.d_ff = ff
        self.wi = init.normal((d, ff), 0.02, dt)
        self.wg = init.normal((d, ff), 0.02, dt)
        self.wo = init.normal((ff, d), out_sc, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """SwiGLU; where ``wi`` holds this rank's columns only, ``wi``/``wg``
        column-parallel and ``wo`` row-parallel, summed over "model"
        (``region_in``, ``region_out``)."""
        group = None if self.wi.shape[1] == self.d_ff else model_group()
        x = region_in(x, group)
        h = F.silu(x @ self.wg) * (x @ self.wi)
        return region_out(h @ self.wo, group)
