"""The Mamba-2 mixer (arXiv:2405.21060 §7), plain float32.

in-projection to [z, x, B, C, dt]; a causal depthwise convolution of width
``ssm_conv`` over [x, B, C] and SiLU; the selective state space
h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_tᵀ, y_t = C_t h_t + D x_t per head,
B and C shared by the heads of a group; a norm of y · silu(z); the
out-projection.  The state space is computed by the paper's chunked
algorithm (its Listing 1): within a chunk the masked product
(C Bᵀ ∘ L) (x dt), across chunks the states carried one chunk at a time.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from .common import rmsnorm

PREFIX = "ssm"


def spec(a) -> dict:
    d, di, nh = a.d_model, a.d_inner, a.ssm_heads
    gs = a.ssm_groups * a.ssm_state
    return {"w_in": ((d, 2 * di + 2 * gs + nh), "normal"),
            "conv_w": ((a.ssm_conv, di + 2 * gs), "conv"),
            "conv_b": ((di + 2 * gs,), "zeros"),
            "A_log": ((nh,), "a_log"),
            "D": ((nh,), "ones32"),
            "dt_bias": ((nh,), "dt_bias"),
            "norm.scale": ((di,), "ones"),
            "w_out": ((di, d), "out")}


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q): [i, j] = x[j+1] + ... + x[i] for i >= j,
    -inf above the diagonal."""
    Q = x.shape[-1]
    xx = x[..., None].expand(*x.shape, Q)                 # [i, j] = x[i]
    below = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device),
                       -1)
    seg = torch.cumsum(xx.masked_fill(~below, 0.0), dim=-2)
    keep = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    return seg.masked_fill(~keep, float("-inf"))


def ssd(nx, x, dt, A, B, C, Q: int) -> torch.Tensor:
    """x: (b, S, nh, hp); dt: (b, S, nh); A: (nh,); B, C: (b, S, G, ds)
    -> y (b, S, nh, hp), from a zero state."""
    b, S, nh, hp = x.shape
    G, ds = B.shape[2], B.shape[3]
    pad = (-S) % Q
    if pad:     # dt = 0 past the end: no input and no decay
        x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (S + pad) // Q
    per = nh // G
    X = (x * dt[..., None]).view(b, nc, Q, nh, hp).transpose(2, 3)
    Bh = B.view(b, nc, Q, G, ds).repeat_interleave(per, 3).transpose(2, 3)
    Ch = C.view(b, nc, Q, G, ds).repeat_interleave(per, 3).transpose(2, 3)
    # X, Bh, Ch: (b, nc, nh, Q, *)
    Ad = (dt * A).view(b, nc, Q, nh).transpose(2, 3)      # (b, nc, nh, Q)
    cum = torch.cumsum(Ad, dim=-1)
    CB = nx.mm(C.view(b, nc, Q, G, ds).transpose(2, 3),
               B.view(b, nc, Q, G, ds).permute(0, 1, 3, 4, 2))
    M = CB.repeat_interleave(per, 2) * torch.exp(segsum(Ad))
    y = nx.mm(M, X)                                       # (b, nc, nh, Q, hp)
    decay = torch.exp(cum[..., -1:] - cum)[..., None]     # to the chunk's end
    states = nx.mm((X * decay).transpose(-1, -2), Bh)     # (b, nc, nh, hp, ds)
    h = torch.zeros_like(states[:, 0])
    before = []
    for c in range(nc):
        before.append(h)
        h = h * torch.exp(cum[:, c, :, -1])[..., None, None] + states[:, c]
    H = torch.stack(before, dim=1)                        # (b, nc, nh, hp, ds)
    y = y + nx.mm(Ch, H.transpose(-1, -2)) * torch.exp(cum)[..., None]
    return y.transpose(2, 3).reshape(b, nc * Q, nh, hp)[:, :S]


def forward(nx, p: dict, x, a, positions):
    """x: (B, S, d) float32 -> (B, S, d)."""
    Bn, S, _ = x.shape
    di, nh, hp = a.d_inner, a.ssm_heads, a.ssm_head_dim
    G, ds, K = a.ssm_groups, a.ssm_state, a.ssm_conv
    z, xbc, dt = torch.split(nx.mm(x, p["w_in"]), [di, di + 2 * G * ds, nh],
                             dim=-1)
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(K))
    xh, Bm, Cm = torch.split(F.silu(conv + p["conv_b"]),
                             [di, G * ds, G * ds], dim=-1)
    xh = xh.reshape(Bn, S, nh, hp)
    A = -torch.exp(p["A_log"])
    dt = F.softplus(dt + p["dt_bias"])
    y = ssd(nx, xh, dt, A, Bm.reshape(Bn, S, G, ds), Cm.reshape(Bn, S, G, ds),
            a.ssm_chunk)
    y = (y + xh * p["D"][:, None]).reshape(Bn, S, di)
    return nx.mm(rmsnorm(y * F.silu(z), p["norm.scale"], a.norm_eps),
                 p["w_out"])
