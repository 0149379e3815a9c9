"""Plain PyTorch versions of the hand-written kernels (the ground truth).

Each kernel wrapper in this package runs its plain version here when it is
given CPU tensors; ``chip_smoke.py`` holds every kernel against its plain
version on the card.  The backward versions are the gradient formulas
written out, not autograd of the forward ones.  Everything is computed in
float32 (float64 inputs stay float64, so the tests can ``gradcheck`` the
formulas).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions compute in: float32, or float64 for
    float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C = A @ B computed in float32, returned in ``promote_types(a, b)``."""
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    return (a.float() @ b.float()).to(out_dtype)


def _band(sq: int, skv: int, causal: bool, window: int, device,
          q_offset: int = 0) -> torch.Tensor:
    """(Sq, Skv) bool: key kept for query iff ``k_pos <= q_pos`` (causal)
    and ``k_pos > q_pos - window`` (window > 0); query row i sits at
    ``q_pos = q_offset + i``, keys at 0..Skv-1."""
    qp = q_offset + torch.arange(sq, device=device)[:, None]
    kp = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= kp > qp - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None, return_lse: bool = False,
                        q_offset: int = 0):
    """Masked softmax attention with GQA head grouping, in float32.

    q: (B, Sq, H, Dk); k: (B, Skv, KH, Dk); v: (B, Skv, KH, Dv); returns
    (B, Sq, H, Dv) in q's dtype, and with ``return_lse`` also each row's
    log-sum-exp of its scaled scores, (B, H, Sq) in float32.  Query head h
    reads KV head h // (H/KH).  Query row i sits at position ``q_offset +
    i``, keys at 0..Skv-1.  A key is kept iff ``k_pos <= q_pos`` (causal)
    and ``k_pos > q_pos - window`` (window > 0); masked scores are set to
    -1e30 before the softmax.  A row that keeps no key is 0 (its lse
    -1e30), as the kernels write it.
    """
    B, Sq, H, Dk = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    wide = _wide(q.dtype)
    if scale is None:
        scale = 1.0 / math.sqrt(Dk)
    kx = k.to(wide).repeat_interleave(G, dim=2)
    vx = v.to(wide).repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(wide), kx) * scale
    band = _band(Sq, Skv, causal, window, q.device, q_offset)
    s = s.masked_fill(~band, NEG_INF)
    p = torch.softmax(s, dim=-1).masked_fill(~band.any(-1)[:, None], 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vx).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def _group_sum(x: torch.Tensor, groups: int, dim: int) -> torch.Tensor:
    """Sum dim ``dim`` (of size groups * g, heads in group order) over each
    run of g consecutive heads: the gradient of ``repeat_interleave``."""
    shape = x.shape
    return x.reshape(*shape[:dim], groups, shape[dim] // groups,
                     *shape[dim + 1:]).sum(dim + 1)


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                            window: int = 0, scale: float | None = None,
                            round_to: torch.dtype | None = None,
                            q_offset: int = 0):
    """Gradients (dq, dk, dv) of ``flash_attention_ref`` given its output
    ``o``, the output's gradient ``do`` and the rows' log-sum-exp ``lse``
    (B, H, Sq), in float32, returned in q's, k's and v's dtypes:
    P = exp(S*scale - lse) on kept pairs, dV = P^T dO, dP = dO V^T,
    D = rowsum(dO o O), dS = P o (dP - D), dQ = scale dS K,
    dK = scale dS^T Q; dK and dV summed over each KV head's query heads.
    Query row i sits at position ``q_offset + i``; a row that keeps no key
    has P = 0, so it adds nothing to any gradient and its dq is 0.

    ``round_to`` (e.g. ``torch.bfloat16``) rounds P to that dtype before
    dV = P^T dO and dS before dQ and dK, where a tensor-core backward
    rounds its MMA operands (the sm90 kernel does); dS itself is taken from
    the unrounded P, and every sum stays in float32.  None: no rounding."""
    B, Sq, H, Dk = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    wide = _wide(q.dtype)
    if scale is None:
        scale = 1.0 / math.sqrt(Dk)
    qw, dow = q.to(wide), do.to(wide)
    kx = k.to(wide).repeat_interleave(G, dim=2)
    vx = v.to(wide).repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qw, kx) * scale
    kept = _band(Sq, Skv, causal, window, q.device, q_offset)
    p = torch.exp(torch.where(kept, s - lse.to(wide)[..., None],
                              -torch.inf))
    def operand(x):
        return x if round_to is None else x.to(round_to).to(wide)

    dv = torch.einsum("bhqk,bqhd->bkhd", operand(p), dow)
    dp = torch.einsum("bqhd,bkhd->bhqk", dow, vx)
    D = (dow * o.to(wide)).sum(-1).transpose(1, 2)          # (B, H, Sq)
    ds = operand(p * (dp - D[..., None]))
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, kx)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, qw)
    return (dq.to(q.dtype), _group_sum(dk, KH, 2).to(k.dtype),
            _group_sum(dv, KH, 2).to(v.dtype))


def ssd_chunk_ref(xdt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  cum: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD intra-chunk output and chunk states, in float32.

    xdt: (b, NC, Q, nh, hp); B, C: (b, NC, Q, G, ds); cum: (b, NC, Q, nh),
    the within-chunk cumulative sum of dt*A.  Head h reads group h // (nh/G).
    Returns y (b, NC, Q, nh, hp) in xdt's dtype and states
    (b, NC, nh, ds, hp) in float32.  The decay exp(cum_q - cum_t) is
    selected, not multiplied, where q < t: there it may overflow to inf
    (autograd of this function is NaN there; ``ssd_chunk_bwd_ref`` is the
    gradient).
    """
    Q, nh = xdt.shape[2], xdt.shape[3]
    hg = nh // B.shape[3]
    wide = _wide(xdt.dtype)
    Bh = B.to(wide).repeat_interleave(hg, dim=3)         # (b,NC,Q,nh,ds)
    Ch = C.to(wide).repeat_interleave(hg, dim=3)
    x = xdt.to(wide)
    cum = cum.to(wide)
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


def ssd_chunk_bwd_ref(xdt, B, C, cum, dy, dstates):
    """Gradients (dxdt, dB, dC, dcum) of ``ssd_chunk_ref`` given the
    gradients ``dy`` of y and ``dstates`` of the states, in float32,
    returned in the inputs' dtypes.  Per (batch, chunk, head h, group g):
    L = exp(cum_q - cum_t) on q >= t (exp only of kept differences, so a
    decay that leaves float32's range never meets a zero cotangent as inf),
    M = (C B^T) o L, w_t = exp(cum_{Q-1} - cum_t);
    dM = (dy xdt^T) o [q >= t], dxdt = M^T dy + w o (B dstates),
    dCB_g = sum_h dM o L, dC = dCB B, dB = dCB^T C + sum_h w o (xdt dstates^T);
    dcum_q += sum_t E, dcum_t -= sum_q E with E = dM o M, and
    dcum_{Q-1} += sum_t F_t, dcum_t -= F_t with
    F_t = w_t sum_{s,p} B[t,s] xdt[t,p] dstates[s,p]."""
    Q, nh = xdt.shape[2], xdt.shape[3]
    G = B.shape[3]
    hg = nh // G
    wide = _wide(xdt.dtype)
    Bh = B.to(wide).repeat_interleave(hg, dim=3)          # (b,NC,Q,nh,ds)
    Ch = C.to(wide).repeat_interleave(hg, dim=3)
    x, dyw, dst = xdt.to(wide), dy.to(wide), dstates.to(wide)
    cw = cum.to(wide)
    ct = cw.transpose(2, 3)                               # (b,NC,nh,Q)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xdt.device))
    L = torch.exp(torch.where(causal, ct[..., :, None] - ct[..., None, :],
                              -torch.inf))                # (b,NC,nh,Q,Q)
    M = torch.einsum("bnqhs,bnths->bnhqt", Ch, Bh) * L
    dM = torch.einsum("bnqhp,bnthp->bnhqt", dyw, x) * causal
    w = torch.exp(cw[:, :, -1:, :] - cw)                  # (b,NC,Q,nh)
    dxdt = (torch.einsum("bnhqt,bnqhp->bnthp", M, dyw)
            + w[..., None] * torch.einsum("bnths,bnhsp->bnthp", Bh, dst))
    dCB = dM * L
    xs = torch.einsum("bnthp,bnhsp->bnths", x, dst)      # xdt dstates^T
    dC = torch.einsum("bnhqt,bnths->bnqhs", dCB, Bh)
    dB = (torch.einsum("bnhqt,bnqhs->bnths", dCB, Ch) + w[..., None] * xs)
    E = dM * M
    F = w * (Bh * xs).sum(-1)                             # (b,NC,Q,nh)
    dcum = (E.sum(-1) - E.sum(-2)).transpose(2, 3) - F
    dcum[:, :, -1, :] += F.sum(2)
    return (dxdt.to(xdt.dtype), _group_sum(dB, G, 3).to(B.dtype),
            _group_sum(dC, G, 3).to(C.dtype), dcum.to(cum.dtype))
