"""Mamba-2 / SSD (state-space duality) layer — chunked prefill scan and
O(1)-per-token recurrent decode.

Follows "Transformers are SSDs" (arXiv:2405.21060) §6 chunked algorithm:
  y = SSD(x, A, B, C) with per-head scalar decay A, grouped B/C (G groups).
The quadratic intra-chunk part and the chunk states come from
``kernels.ssd_chunk`` (K3: the hand-written CUDA kernel on the card, its
plain version on the CPU); the inter-chunk recurrence is a loop over
chunks in torch.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..kernels import ssd_chunk
from .config import ArchConfig
from .layers import F32, Init, RMSNorm, _dtype, _linear


class SSM(nn.Module):
    def __init__(self, cfg: ArchConfig, init: Init):
        super().__init__()
        dt = _dtype(cfg)
        d, di = cfg.d_model, cfg.d_inner
        nh, ds, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
        conv_dim = di + 2 * G * ds
        out_sc = 0.02 / math.sqrt(2 * cfg.num_layers)
        self.cfg = cfg
        # fused input projection: [z, x, B, C, dt]
        self.w_in = init.normal((d, 2 * di + 2 * G * ds + nh), 0.02, dt)
        self.conv_w = init.normal((cfg.ssm_conv, conv_dim), 0.2, dt)
        self.conv_b = init.const(torch.zeros((conv_dim,), dtype=dt))
        self.A_log = init.const(torch.log(torch.linspace(1.0, 16.0, nh)))
        self.D = init.const(torch.ones((nh,), dtype=F32))
        self.dt_bias = init.const(torch.zeros((nh,), dtype=F32))
        self.norm = RMSNorm(di, dt, init)
        self.w_out = init.normal((di, d), out_sc, dt)

    def _split_proj(self, x: torch.Tensor):
        cfg = self.cfg
        di, G, ds = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
        zxbcdt = _linear(x, self.w_in)
        return torch.split(zxbcdt, [di, di + 2 * G * ds, cfg.ssm_heads],
                           dim=-1)

    def _heads(self, xBC: torch.Tensor):
        cfg = self.cfg
        di, ds, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
        xh, B, C = torch.split(xBC, [di, G * ds, G * ds], dim=-1)
        b, s = xh.shape[:2]
        return (xh.reshape(b, s, cfg.ssm_heads, cfg.ssm_head_dim),
                B.reshape(b, s, G, ds), C.reshape(b, s, G, ds))

    def forward(self, x: torch.Tensor):
        """Prefill forward.  x: (B, S, d_model).  Returns (out, {"state",
        "conv"}): the final recurrent state (B, nh, hp, ds) in f32 and the
        pre-activation conv tail (B, K-1, conv_dim)."""
        cfg = self.cfg
        z, xBC_raw, dt = self._split_proj(x)
        w = self.conv_w.float()                         # (K, conv_dim)
        K, S = w.shape[0], x.shape[1]
        xp = F.pad(xBC_raw.float(), (0, 0, K - 1, 0))
        conv = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
        xBC = F.silu(conv + self.conv_b.float()).to(xBC_raw.dtype)
        xh, B, C = self._heads(xBC)
        A = -torch.exp(self.A_log)
        dt_s = F.softplus(dt.float() + self.dt_bias)
        y, state = ssd_scan(xh, B, C, dt_s, A, chunk=cfg.ssm_chunk)
        y = y + xh.float() * self.D[None, None, :, None]
        y = y.reshape(x.shape[0], S, cfg.d_inner).to(x.dtype)
        y = self.norm(y * F.silu(z), cfg.norm_eps)
        out = y @ self.w_out
        # The pre-activation window tail, copied: a view would keep the
        # whole projection output alive in the cache of every layer.
        conv_tail = xBC_raw[:, -(K - 1):, :].clone()
        if S < K - 1:
            conv_tail = F.pad(xBC_raw, (0, 0, K - 1 - S, 0))
        return out, {"state": state, "conv": conv_tail}

    def decode(self, x: torch.Tensor, cache: dict) -> torch.Tensor:
        """One-token recurrent step.  x: (B, 1, d_model).  Replaces
        ``cache["state"]`` (B, nh, hp, ds) and ``cache["conv"]``
        (B, K-1, conv_dim) in place."""
        cfg = self.cfg
        b = x.shape[0]
        nh, G = cfg.ssm_heads, cfg.ssm_groups
        z, xBC, dt = self._split_proj(x)
        window = torch.cat([cache["conv"], xBC], dim=1)          # (B, K, conv)
        conv_out = ((window.float() * self.conv_w.float()[None]).sum(dim=1)
                    + self.conv_b.float())
        xBC_t = F.silu(conv_out)[:, None, :].to(x.dtype)
        cache["conv"].copy_(window[:, 1:])

        xh, B, C = self._heads(xBC_t)
        xh, B, C = xh[:, 0], B[:, 0], C[:, 0]                    # (B,nh,hp),(B,G,ds)
        hg = nh // G
        B_h = B.repeat_interleave(hg, dim=1).float()              # (B,nh,ds)
        C_h = C.repeat_interleave(hg, dim=1).float()
        A = -torch.exp(self.A_log)
        dt_s = F.softplus(dt[:, 0].float() + self.dt_bias)        # (B,nh)
        dA = torch.exp(dt_s * A[None])                            # (B,nh)
        upd = torch.einsum("bhp,bhs->bhps", xh.float() * dt_s[..., None], B_h)
        state = cache["state"] * dA[..., None, None] + upd
        cache["state"].copy_(state)
        y = torch.einsum("bhps,bhs->bhp", state, C_h)
        y = y + xh.float() * self.D[None, :, None]
        y = y.reshape(b, 1, cfg.d_inner).to(x.dtype)
        y = self.norm(y * F.silu(z), cfg.norm_eps)
        return y @ self.w_out


def ssd_scan(xh, B, C, dt, A, *, chunk: int):
    """Chunked SSD.  xh: (b,S,nh,hp)  B,C: (b,S,G,ds)  dt: (b,S,nh)  A: (nh,).

    Heads are split evenly over the G groups.  Returns y: (b,S,nh,hp) in f32
    and the final state (b,nh,hp,ds).  The intra-chunk output and the chunk
    states come from K3 (``kernels.ssd_chunk``).
    """
    b, S, nh, hp = xh.shape
    G, ds = B.shape[2], B.shape[3]
    hg = nh // G
    Q = min(chunk, S)
    NC = -(-S // Q)
    pad = NC * Q - S
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    xc = xh.reshape(b, NC, Q, nh, hp).float()
    Bc = B.reshape(b, NC, Q, G, ds).float()
    Cc = C.reshape(b, NC, Q, G, ds).float()
    dtc = dt.reshape(b, NC, Q, nh).float()

    dA = dtc * A[None, None, None, :]                 # (b,NC,Q,nh) negative
    cum = torch.cumsum(dA, dim=2)                     # within-chunk cumsum
    seg_end = cum[:, :, -1, :]                        # (b,NC,nh)

    # --- intra-chunk output and chunk states: K3 ---
    xdt = xc * dtc[..., None]                         # (b,NC,Q,nh,hp)
    y_intra, states = ssd_chunk(xdt, Bc, Cc, cum)     # states (b,NC,nh,ds,hp)
    states = states.transpose(-1, -2)                 # (b,NC,nh,hp,ds)

    # --- inter-chunk recurrence: H_c = H_{c-1} * exp(seg_end_c) + S_c ---
    seg_decay = torch.exp(seg_end)                    # (b,NC,nh)
    h = torch.zeros_like(states[:, 0])
    h_prev = []
    for c in range(NC):
        h_prev.append(h)
        h = h * seg_decay[:, c, :, None, None] + states[:, c]
    H_prev = torch.stack(h_prev, dim=1)               # (b,NC,nh,hp,ds)

    # --- inter-chunk output: y_t += C_t · (exp(cum_t) * H_prev) ---
    Cc_h = Cc.repeat_interleave(hg, dim=3) if G != nh else Cc
    y_inter = torch.einsum("bnths,bnhps->bnthp", Cc_h,
                           H_prev) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, NC * Q, nh, hp)[:, :S]
    return y, h


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                   device: torch.device) -> dict:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=F32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }
