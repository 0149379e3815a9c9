"""Pieces every block of the plain reference shares: the architecture's
sizes, RMSNorm, rotary embedding and causal attention, all in float32."""
from __future__ import annotations

import torch

F32 = torch.float32


class Arch:
    """A configuration file's ``model`` section, key for key, with the
    sizes derived from it."""

    def __init__(self, model: dict):
        self.__dict__.update(model)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(F32)
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` (B, S, H, D), rotating its two halves
    against each other at ``theta ** (-i / (D / 2))`` per position."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = positions.to(F32)[:, None] * freqs                    # (S, D/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(nx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, block: int = 1024) -> torch.Tensor:
    """Softmax attention of each query over the keys at or before it.
    q, k: (B, S, H, Dk); v: (B, S, H, Dv) -> (B, S, H, Dv).  One sequence
    and ``block`` queries at a time, so the scores stay (H, block, S)."""
    B, S, H, _ = q.shape
    rows = []
    for b in range(B):
        kt = k[b].permute(1, 2, 0)                              # (H, Dk, S)
        vt = v[b].transpose(0, 1)                               # (H, S, Dv)
        outs = []
        for a in range(0, S, block):
            e = min(a + block, S)
            s = nx.mm(q[b, a:e].transpose(0, 1), kt[..., :e]) * scale
            keep = (torch.arange(e, device=q.device)[None, :]
                    <= torch.arange(a, e, device=q.device)[:, None])
            s = s.masked_fill(~keep, float("-inf"))
            outs.append(nx.mm(torch.softmax(s, dim=-1), vt[:, :e]))
        rows.append(torch.cat(outs, dim=1).transpose(0, 1))     # (S, H, Dv)
    return torch.stack(rows)
