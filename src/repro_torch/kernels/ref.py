"""Plain PyTorch versions of the hand-written kernels (the ground truth).

Each kernel wrapper in this package runs its plain version here when it is
given CPU tensors; ``chip_smoke.py`` holds every kernel against its plain
version on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C = A @ B computed in float32, returned in ``promote_types(a, b)``."""
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    return (a.float() @ b.float()).to(out_dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """Masked softmax attention with GQA head grouping, in float32.

    q: (B, Sq, H, Dk); k: (B, Skv, KH, Dk); v: (B, Skv, KH, Dv); returns
    (B, Sq, H, Dv) in q's dtype.  Query head h reads KV head h // (H/KH).
    A key is kept iff ``k_pos <= q_pos`` (causal) and ``k_pos > q_pos -
    window`` (window > 0); masked scores are set to -1e30 before the softmax.
    """
    B, Sq, H, Dk = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    if scale is None:
        scale = 1.0 / math.sqrt(Dk)
    kx = k.float().repeat_interleave(G, dim=2)
    vx = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * scale
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= kp > qp - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vx).to(q.dtype)


def ssd_chunk_ref(xdt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  cum: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD intra-chunk output and chunk states, in float32.

    xdt: (b, NC, Q, nh, hp); B, C: (b, NC, Q, G, ds); cum: (b, NC, Q, nh),
    the within-chunk cumulative sum of dt*A.  Head h reads group h // (nh/G).
    Returns y (b, NC, Q, nh, hp) in xdt's dtype and states
    (b, NC, nh, ds, hp) in float32.  The decay exp(cum_q - cum_t) is
    selected, not multiplied, where q < t: there it may overflow to inf.
    """
    Q, nh = xdt.shape[2], xdt.shape[3]
    hg = nh // B.shape[3]
    Bh = B.float().repeat_interleave(hg, dim=3)          # (b,NC,Q,nh,ds)
    Ch = C.float().repeat_interleave(hg, dim=3)
    x = xdt.float()
    cum = cum.float()
    cb = torch.einsum("bnqhs,bnths->bnhqt", Ch, Bh)
    ct = cum.transpose(2, 3)                             # (b,NC,nh,Q)
    diff = ct[..., :, None] - ct[..., None, :]           # (b,NC,nh,Q,Q)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xdt.device))
    decay = torch.where(causal, torch.exp(diff),
                        torch.zeros((), device=xdt.device))
    y = torch.einsum("bnhqt,bnthp->bnqhp", cb * decay, x)
    w = torch.exp(cum[:, :, -1:, :] - cum)               # (b,NC,Q,nh)
    states = torch.einsum("bnqhs,bnqhp->bnhsp", Bh * w[..., None], x)
    return y.to(xdt.dtype), states
