"""Multi-head latent attention (DeepSeek-V2 §2.1, MiniCPM3), plain float32.

Queries go down to a latent of ``q_lora_rank`` and back up per head; keys
and values come from one shared latent of ``kv_lora_rank`` (normed) plus
a rotary key of ``qk_rope_head_dim`` shared by all heads.  Every position
is computed the long way: the latent expanded to per-head keys and values,
whatever form a served path takes for decoding.
"""
from __future__ import annotations

import math

import torch

from .common import causal_attention, rmsnorm, rope

PREFIX = "attn"


def spec(a) -> dict:
    d, H = a.d_model, a.num_heads
    nope, rp, vd = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim
    qr, kvr = a.q_lora_rank, a.kv_lora_rank
    return {"wq_a": ((d, qr), "normal"),
            "wq_b": ((qr, H, nope + rp), "normal"),
            "wkv_a": ((d, kvr + rp), "normal"),
            "wk_b": ((kvr, H, nope), "normal"),
            "wv_b": ((kvr, H, vd), "normal"),
            "wo": ((H, vd, d), "out"),
            "q_norm.scale": ((qr,), "ones"),
            "kv_norm.scale": ((kvr,), "ones")}


def forward(nx, p: dict, x, a, positions):
    """x: (B, S, d) float32 -> (B, S, d)."""
    B, S, d = x.shape
    H = a.num_heads
    nope, rp, vd = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim
    qr, kvr = a.q_lora_rank, a.kv_lora_rank
    cq = rmsnorm(nx.mm(x, p["wq_a"]), p["q_norm.scale"], a.norm_eps)
    q = nx.mm(cq, p["wq_b"].reshape(qr, -1)).view(B, S, H, nope + rp)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], positions,
                                       a.rope_theta)], dim=-1)
    kv = nx.mm(x, p["wkv_a"])
    ckv = rmsnorm(kv[..., :kvr], p["kv_norm.scale"], a.norm_eps)
    k_rope = rope(kv[..., None, kvr:], positions, a.rope_theta)
    k_nope = nx.mm(ckv, p["wk_b"].reshape(kvr, -1)).view(B, S, H, nope)
    v = nx.mm(ckv, p["wv_b"].reshape(kvr, -1)).view(B, S, H, vd)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, rp)], dim=-1)
    o = causal_attention(nx, q, k, v, 1.0 / math.sqrt(nope + rp))
    return nx.mm(o.reshape(B, S, H * vd), p["wo"].reshape(H * vd, d))

