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
this rank's batch shard with full (gathered) weights, replicated over
"model"; the reference's ``constrain`` calls on the decode queries stand
where its do, and leave a plain tensor as it is.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..distributed.context import constrain, current_mesh, model_axis_size
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
    """One decode step.  q: (B, 1, H, Dk); caches: (B, S, KH, D*).

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


class Attention(nn.Module):
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

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        q, k, v = (_linear(x, self.wq), _linear(x, self.wk),
                   _linear(x, self.wv))
        if self.cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = apply_rope(q, positions, self.cfg.rope_theta)
        k = apply_rope(k, positions, self.cfg.rope_theta)
        return q, k, v

    def forward(self, x: torch.Tensor, *, window: int = 0):
        """Full-sequence (prefill) attention; returns (out, {"k", "v"})."""
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        q, k, v = self.qkv(x, positions)
        o = flash_attention(q, k, v, causal=True, window=window)
        return _linear(o.flatten(-2), self.wo.flatten(0, 1)), {"k": k, "v": v}

    def decode(self, x: torch.Tensor, cache: dict, pos: int, *,
               window: int = 0) -> torch.Tensor:
        """x: (B, 1, d).  Writes this token's K/V into ``cache["k"]``,
        ``cache["v"]`` (B, S, KH, hd) at ``pos``, in place; a ``pos`` past
        the end writes the last slot, as the reference's
        ``dynamic_update_slice`` clamps its start."""
        positions = torch.full((x.shape[0], 1), pos, device=x.device)
        q, k, v = self.qkv(x, positions)
        slot = min(pos, cache["k"].shape[1] - 1)
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        o = decode_attention(q, cache["k"], cache["v"], pos + 1,
                             window=window)
        return _linear(o.flatten(-2), self.wo.flatten(0, 1))


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------


class MLA(nn.Module):
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

    def _q(self, x, positions):
        cfg = self.cfg
        nope = cfg.qk_nope_head_dim
        cq = self.q_norm(_linear(x, self.wq_a), cfg.norm_eps)
        q = _linear(cq, self.wq_b)
        q_nope, q_rope = q[..., :nope], q[..., nope:]
        return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)

    def _latent(self, x, positions):
        cfg = self.cfg
        kvr = cfg.kv_lora_rank
        kv = _linear(x, self.wkv_a)
        ckv = self.kv_norm(kv[..., :kvr], cfg.norm_eps)
        k_rope = apply_rope(kv[..., None, kvr:], positions, cfg.rope_theta)
        return ckv, k_rope[..., 0, :]

    def forward(self, x: torch.Tensor, *, window: int = 0):
        """Prefill MLA: expand the latent to per-head K/V and attend through
        K2.  K per head = [W_kb·c ; k_rope (shared)]; V per head = W_vb·c.
        Returns (out, {"ckv", "krope"})."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, nope, rope = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        positions = torch.arange(S, device=x.device)[None, :]
        q_nope, q_rope = self._q(x, positions)
        ckv, k_rope = self._latent(x, positions)
        k_nope = _linear(ckv, self.wk_b)
        v = _linear(ckv, self.wv_b)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope)],
                      dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        o = flash_attention(q, k, v, causal=True,
                            scale=1.0 / math.sqrt(nope + rope))
        out = _linear(o.flatten(-2), self.wo.flatten(0, 1))
        return out, {"ckv": ckv, "krope": k_rope}

    def decode(self, x: torch.Tensor, cache: dict, pos: int, *,
               window: int = 0) -> torch.Tensor:
        """Absorbed-matmul MLA decode: score against the *latent* cache
        (``cache["ckv"]`` (B, S, kvr), ``cache["krope"]`` (B, S, rope)),
        written at ``min(pos, S - 1)`` in place, as in ``Attention.decode``."""
        cfg = self.cfg
        positions = torch.full((x.shape[0], 1), pos, device=x.device)
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
        return _linear(o.flatten(-2), self.wo.flatten(0, 1))


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, init: Init, d_ff: int | None = None):
        super().__init__()
        dt = _dtype(cfg)
        d, ff = cfg.d_model, d_ff or cfg.d_ff
        out_sc = 0.02 / math.sqrt(2 * cfg.num_layers)
        self.wi = init.normal((d, ff), 0.02, dt)
        self.wg = init.normal((d, ff), 0.02, dt)
        self.wo = init.normal((ff, d), out_sc, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(x @ self.wg) * (x @ self.wi)
        return h @ self.wo
