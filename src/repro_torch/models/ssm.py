"""Mamba-2 / SSD (state-space duality) layer — chunked prefill scan and
O(1)-per-token recurrent decode.

Follows "Transformers are SSDs" (arXiv:2405.21060) §6 chunked algorithm:
  y = SSD(x, A, B, C) with per-head scalar decay A, grouped B/C (G groups).
The quadratic intra-chunk part and the chunk states come from
``kernels.ssd_chunk`` (K3: the hand-written CUDA kernel on the card, its
plain version on the CPU); the inter-chunk recurrence is a loop over
chunks in torch.

Under a mesh whose "model" axis has n > 1 ranks and n divides the SSM's
heads, the mixer is tensor-parallel, as the reference's sharding makes XLA
compute it: rank r computes heads [r·nh/n, (r+1)·nh/n) and the B/C groups
they read (``layers.split_heads``; every configuration has one group, so
all of B and C).  ``w_out`` keeps its "model" rows, which are those heads'
channels (``model_dims``), and its product is summed over "model"
(``collectives.region_out``: ``psum`` in the activations' dtype; under
Megatron-SP the rank's rows of it).  Every other leaf is gathered whole
and narrowed to the rank's share, its gradient summed over "model"
(``sum_grads``): ``w_in``'s columns of z, x and dt of those heads and of
their B and C (the reference's contiguous "model" shard of the
concatenated [z, x, B, C, dt] columns is not a split by heads), the conv's
channels of x, B and C, ``A_log``, ``D``, ``dt_bias`` and the norm's scale.
The gated RMSNorm over d_inner sums each rank's float32 sum of squares over
"model" (``layers.rmsnorm_split``).  K3 and K3-bwd run on the local heads.
Decode's ``state`` cache holds the rank's heads (the reference's "model"
shard of it), and its ``conv`` cache the rank's channels: its heads' x
channels, then its groups' B and C.  That differs from the reference's
contiguous shard of ``conv_dim``.  Where n does not divide the heads, the
mixer is gathered whole and every head runs on every rank, even where n
divides d_inner (hymba: 3200 channels, 50 heads): ``w_out``'s rule shards
its rows there, which would split a head, so the heads decide.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.nn import functional as F

from ..distributed.collectives import region_in, region_out, sum_grads
from ..distributed.context import (current_mesh, model_axis_size,
                                   model_group, model_rank)
from ..kernels import ssd_chunk
from .config import ArchConfig
from .layers import (F32, HeadShard, Init, RMSNorm, _dtype, _linear,
                     rmsnorm_split, split_heads)


@dataclasses.dataclass
class _Leaves:
    """What one call of an ``SSM`` computes with: the module's leaves and
    its head and group counts, or under a tensor-parallel mesh the rank's
    share of them."""
    w_in: torch.Tensor
    conv_w: torch.Tensor
    conv_b: torch.Tensor
    A_log: torch.Tensor
    D: torch.Tensor
    dt_bias: torch.Tensor
    norm: torch.Tensor
    heads: int
    groups: int


def _channels(cfg: ArchConfig, sh: HeadShard):
    """The rank's (start, length) pieces of ``w_in``'s columns [z, x, B,
    C, dt] and of the conv's channels [x, B, C] under ``sh``."""
    di, ds, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    x = (sh.h0 * cfg.ssm_head_dim, sh.hl * cfg.ssm_head_dim)
    g0, gl = sh.kv0 * ds, (sh.kv1 - sh.kv0) * ds
    conv = [x, (di + g0, gl), (di + G * ds + g0, gl)]
    w_in = [x, *((di + a, n) for a, n in conv),
            (2 * di + 2 * G * ds + sh.h0, sh.hl)]
    return w_in, conv


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

    @property
    def model_dims(self) -> dict[str, int]:
        """The dim each leaf keeps sharded over "model" under the installed
        mesh (``distributed.sharding.gathered``): ``w_out``'s rows, where
        the heads divide the axis; none elsewhere."""
        n = model_axis_size()
        return {"w_out": 0} if n > 1 and self.cfg.ssm_heads % n == 0 else {}

    def head_shard(self) -> HeadShard | None:
        """This rank's heads and the B/C groups they read, or None where
        the mixer runs whole: no mesh, a "model" axis of one rank, heads
        that do not divide it, or a ``w_out`` that holds every row (read
        as a call sees it or, outside one, from its shard)."""
        cfg = self.cfg
        w = self.w_out
        if not self.model_dims or (
                w.to_local() if isinstance(w, DTensor) else w).shape[0] \
                == cfg.d_inner:
            return None
        mesh = current_mesh()
        return split_heads(cfg.ssm_heads, cfg.ssm_groups,
                           model_axis_size(mesh), model_rank(mesh),
                           model_group(mesh))

    def _leaves(self, sh: HeadShard | None) -> _Leaves:
        cfg = self.cfg
        if sh is None:
            return _Leaves(self.w_in, self.conv_w, self.conv_b, self.A_log,
                           self.D, self.dt_bias, self.norm.scale,
                           cfg.ssm_heads, cfg.ssm_groups)

        def take(w, dim, pieces):
            w = sum_grads(w, sh.group)
            parts = [w.narrow(dim, a, n) for a, n in pieces]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

        w_in, conv = _channels(cfg, sh)
        heads = [(sh.h0, sh.hl)]
        return _Leaves(take(self.w_in, 1, w_in), take(self.conv_w, 1, conv),
                       take(self.conv_b, 0, conv), take(self.A_log, 0, heads),
                       take(self.D, 0, heads), take(self.dt_bias, 0, heads),
                       take(self.norm.scale, 0, w_in[:1]), sh.hl,
                       sh.kv1 - sh.kv0)

    def _split_proj(self, x: torch.Tensor, p: _Leaves):
        di, ds = p.heads * self.cfg.ssm_head_dim, self.cfg.ssm_state
        zxbcdt = _linear(x, p.w_in)
        return torch.split(zxbcdt, [di, di + 2 * p.groups * ds, p.heads],
                           dim=-1)

    def _heads(self, xBC: torch.Tensor, p: _Leaves, sh: HeadShard | None):
        """x by head, and B, C by group; under ``sh`` with groups its heads
        read unevenly, B and C repeated once per local head."""
        cfg = self.cfg
        di, ds = p.heads * cfg.ssm_head_dim, cfg.ssm_state
        xh, B, C = torch.split(xBC, [di, p.groups * ds, p.groups * ds],
                               dim=-1)
        b, s = xh.shape[:2]
        xh = xh.reshape(b, s, p.heads, cfg.ssm_head_dim)
        B, C = B.reshape(b, s, p.groups, ds), C.reshape(b, s, p.groups, ds)
        if sh is not None and sh.expand is not None:
            idx = torch.tensor(sh.expand, device=B.device)
            B, C = B.index_select(2, idx), C.index_select(2, idx)
        return xh, B, C

    def _norm(self, y: torch.Tensor, p: _Leaves,
              sh: HeadShard | None) -> torch.Tensor:
        eps = self.cfg.norm_eps
        if sh is None:
            return self.norm(y, eps)
        return rmsnorm_split(p.norm, y, eps, self.cfg.d_inner, sh.group)

    def _out(self, y: torch.Tensor, sh: HeadShard | None) -> torch.Tensor:
        return region_out(y @ self.w_out, None if sh is None else sh.group)

    def forward(self, x: torch.Tensor):
        """Prefill forward.  x: (B, S, d_model).  Returns (out, {"state",
        "conv"}): the final recurrent state (B, nh, hp, ds) in f32 and the
        pre-activation conv tail (B, K-1, conv_dim); under a
        tensor-parallel mesh, the rank's heads and channels.  Under
        Megatron-SP ``x`` and the output are this rank's rows of the
        sequence (``region_in``, ``region_out``)."""
        cfg = self.cfg
        sh = self.head_shard()
        x = region_in(x, None if sh is None else sh.group)
        p = self._leaves(sh)
        z, xBC_raw, dt = self._split_proj(x, p)
        w = p.conv_w.float()                            # (K, conv_dim)
        K, S = w.shape[0], x.shape[1]
        xp = F.pad(xBC_raw.float(), (0, 0, K - 1, 0))
        conv = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
        xBC = F.silu(conv + p.conv_b.float()).to(xBC_raw.dtype)
        xh, B, C = self._heads(xBC, p, sh)
        A = -torch.exp(p.A_log)
        dt_s = F.softplus(dt.float() + p.dt_bias)
        y, state = ssd_scan(xh, B, C, dt_s, A, chunk=cfg.ssm_chunk)
        y = y + xh.float() * p.D[None, None, :, None]
        y = y.reshape(x.shape[0], S, -1).to(x.dtype)
        y = self._norm(y * F.silu(z), p, sh)
        out = self._out(y, sh)
        # The pre-activation window tail, copied: a view would keep the
        # whole projection output alive in the cache of every layer.
        conv_tail = xBC_raw[:, -(K - 1):, :].clone()
        if S < K - 1:
            conv_tail = F.pad(xBC_raw, (0, 0, K - 1 - S, 0))
        return out, {"state": state, "conv": conv_tail}

    def decode(self, x: torch.Tensor, cache: dict) -> torch.Tensor:
        """One-token recurrent step.  x: (B, 1, d_model).  Replaces
        ``cache["state"]`` (B, nh, hp, ds) and ``cache["conv"]``
        (B, K-1, conv_dim) in place (the rank's heads and channels under a
        tensor-parallel mesh)."""
        b = x.shape[0]
        sh = self.head_shard()
        p = self._leaves(sh)
        z, xBC, dt = self._split_proj(x, p)
        window = torch.cat([cache["conv"], xBC], dim=1)          # (B, K, conv)
        conv_out = ((window.float() * p.conv_w.float()[None]).sum(dim=1)
                    + p.conv_b.float())
        xBC_t = F.silu(conv_out)[:, None, :].to(x.dtype)
        cache["conv"].copy_(window[:, 1:])

        xh, B, C = self._heads(xBC_t, p, sh)
        xh, B, C = xh[:, 0], B[:, 0], C[:, 0]                    # (B,nh,hp),(B,G,ds)
        hg = xh.shape[1] // B.shape[1]
        B_h = B.repeat_interleave(hg, dim=1).float()              # (B,nh,ds)
        C_h = C.repeat_interleave(hg, dim=1).float()
        A = -torch.exp(p.A_log)
        dt_s = F.softplus(dt[:, 0].float() + p.dt_bias)           # (B,nh)
        dA = torch.exp(dt_s * A[None])                            # (B,nh)
        upd = torch.einsum("bhp,bhs->bhps", xh.float() * dt_s[..., None], B_h)
        state = cache["state"] * dA[..., None, None] + upd
        cache["state"].copy_(state)
        y = torch.einsum("bhps,bhs->bhp", state, C_h)
        y = y + xh.float() * p.D[None, :, None]
        y = y.reshape(b, 1, -1).to(x.dtype)
        y = self._norm(y * F.silu(z), p, sh)
        return self._out(y, sh)


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
                   device: torch.device, sh: HeadShard | None = None) -> dict:
    """A zero decode cache of one layer: every head and channel, or under
    ``sh`` the rank's heads and channels (``SSM.head_shard``)."""
    heads, groups = ((cfg.ssm_heads, cfg.ssm_groups) if sh is None
                     else (sh.hl, sh.kv1 - sh.kv0))
    conv_dim = heads * cfg.ssm_head_dim + 2 * groups * cfg.ssm_state
    return {
        "state": torch.zeros((batch, heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=F32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }
