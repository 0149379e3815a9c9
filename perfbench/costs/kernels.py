"""Each hand-written kernel's operations and bytes for one call, from the
call's input shapes, dtypes and scalar arguments: the benchmark's own copy
of the formulas, so a change to the program cannot move the yardstick.

Operations count the products over the pairs the call keeps (causal or
windowed (query, key) pairs at ``q_offset``; within-chunk pairs q >= t for
the SSD chunk), 2 a multiply-add.  Bytes count each input read once and
each output written once, whatever the kernel reads again.

Each entry takes the operator's arguments as the trace records them:
``shapes`` (one tuple per tensor argument, in order), ``dtypes`` (their
element sizes in bytes) and ``scalars`` (the remaining arguments, in
order).  ``OPS`` maps an operator's name to its entry.
"""
from __future__ import annotations

import math


def band_pairs(sq: int, skv: int, causal: bool, window: int,
               q_offset: int = 0) -> int:
    """(query, key) pairs kept: key j for query row i (at q_offset + i) iff
    j <= q_offset + i when causal, and j > q_offset + i - window when
    window > 0; keys 0..skv-1."""
    total = 0
    for i in range(sq):
        q = q_offset + i
        hi = min(q, skv - 1) if causal else skv - 1
        lo = max(0, q - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def _pairs_closed(sq: int, skv: int, causal: bool, window: int,
                  q_offset: int) -> int:
    """``band_pairs`` without the loop where the band is plain causal."""
    if causal and window <= 0 and q_offset == 0 and skv >= sq:
        return sq * (sq + 1) // 2
    return band_pairs(sq, skv, causal, window, q_offset)


def _nbytes(shape, size: int) -> int:
    return math.prod(shape) * size


def flash_attention(shapes, sizes, scalars, lse: bool = False):
    """K2: S = Q Kᵀ and O = P V over the kept pairs, 2 (Dk + Dv) a pair a
    head; q, k, v read, o (and the float32 lse) written."""
    (B, Sq, H, Dk), k, v = shapes[:3]
    causal, window = bool(scalars[0]), int(scalars[1])
    q_offset = int(scalars[3]) if len(scalars) > 3 else 0
    pairs = _pairs_closed(Sq, k[1], causal, window, q_offset)
    flops = 2 * B * H * (Dk + v[3]) * pairs
    o = (B, Sq, H, v[3])
    nbytes = (sum(_nbytes(s, z) for s, z in zip(shapes[:3], sizes[:3]))
              + _nbytes(o, sizes[0]) + (4 * B * H * Sq if lse else 0))
    return flops, nbytes


def flash_attention_lse(shapes, sizes, scalars):
    return flash_attention(shapes, sizes, scalars, lse=True)


def flash_attention_bwd(shapes, sizes, scalars):
    """K2-bwd: S and dP in both passes, dV, dK, dQ over the kept pairs,
    2 (4 Dk + 3 Dv) a pair a head; q, k, v, o, dO, lse read, dq, dk, dv
    written."""
    (B, Sq, H, Dk), k, v = shapes[:3]
    causal, window = bool(scalars[0]), int(scalars[1])
    q_offset = int(scalars[3]) if len(scalars) > 3 else 0
    pairs = _pairs_closed(Sq, k[1], causal, window, q_offset)
    flops = 2 * B * H * (4 * Dk + 3 * v[3]) * pairs
    read = sum(_nbytes(s, z) for s, z in zip(shapes[:6], sizes[:6]))
    written = sum(_nbytes(s, z) for s, z in zip(shapes[:3], sizes[:3]))
    return flops, read + written


def ssd_chunk(shapes, sizes, scalars):
    """K3: C Bᵀ (ds a pair) and (C Bᵀ ∘ L) xdt (hp a pair) over each
    chunk's Q (Q + 1) / 2 pairs a head, and the chunk state (Q ds hp);
    xdt, B, C, cum read, y and the float32 states written."""
    (b, nc, Q, nh, hp), Bs = shapes[0], shapes[1]
    ds = Bs[4]
    pairs = Q * (Q + 1) // 2
    flops = 2 * b * nc * nh * (pairs * (ds + hp) + Q * ds * hp)
    read = sum(_nbytes(s, z) for s, z in zip(shapes[:4], sizes[:4]))
    written = _nbytes(shapes[0], sizes[0]) + 4 * b * nc * nh * ds * hp
    return flops, read + written


def ssd_chunk_bwd(shapes, sizes, scalars):
    """K3-bwd: dM = dy xdtᵀ and dxdt = Mᵀ dy a head (hp a pair each), C Bᵀ,
    dC and dB a group (ds a pair each), the two state terms a head (Q ds hp
    each); the six inputs read, dxdt, dB, dC, dcum written."""
    (b, nc, Q, nh, hp), Bs = shapes[0], shapes[1]
    G, ds = Bs[3], Bs[4]
    pairs = Q * (Q + 1) // 2
    flops = 2 * b * nc * (pairs * (nh * 2 * hp + G * 3 * ds)
                          + nh * 2 * Q * ds * hp)
    read = sum(_nbytes(s, z) for s, z in zip(shapes[:6], sizes[:6]))
    written = sum(_nbytes(s, z) for s, z in zip(shapes[:4], sizes[:4]))
    return flops, read + written


OPS = {
    "repro_torch::flash_attention": flash_attention,
    "repro_torch::flash_attention_lse": flash_attention_lse,
    "repro_torch::flash_attention_bwd": flash_attention_bwd,
    "repro_torch::ssd_chunk": ssd_chunk,
    "repro_torch::ssd_chunk_bwd": ssd_chunk_bwd,
}
