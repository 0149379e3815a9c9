"""K2's and K2-bwd's float32 route on the tensor cores (``tf32x3``:
``csrc/flash_attention_tf32x3.cu``, ``csrc/flash_attention_bwd_tf32x3.cu``)
on the CPU: a torch emulation of the kernels' arithmetic — every product as
three TF32 products of the hi/lo split (``csrc/sm90_tf32x3.cuh``), through
their tile loops, band skipping, masks and online softmax — held against
the reference, the layout rule that feeds an f32 accumulator to the next
product as its A operand, the shared-memory figures, the route rule and
the launch counts.

The CUDA kernels themselves are held against their plain versions on the
card by ``chip_smoke.py`` (phases 3 and 7 (a)).  Inputs are made with
numpy from a seed.  The forward emulation is held against the reference
kernels' oracle ``repro.kernels.ref.flash_attention_ref`` at K2's float32
gate (2e-5, ``tests/test_kernels_flash.py``); the backward emulation
against ``jax.vjp`` of the reference model stack's ``flash_attention``
(``src/repro/models/layers.py:90``) at K2-bwd's (1e-4).
"""
import importlib
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models.layers import flash_attention as jax_flash
from repro_torch.kernels import _nvcc, flash_attention, flash_attention_bwd
from repro_torch.kernels.ref import flash_attention_ref

fa = importlib.import_module("repro_torch.kernels.flash_attention")

K2_GATE = 2e-5        # rtol = atol, tests/test_kernels_flash.py
K2B_GATE = 1e-4       # rtol = atol, chip_smoke.K2B_TOL["float32"]
LSE_TOL = 1e-5        # chip_smoke.LSE_TOL
BT = 64               # query and key tile of both kernels
LOG2E = 1.4426950408889634
SMEM_LIMIT = 232_448  # poas_sm90::kSmemLimit


# ---- 3xTF32, as the kernels split and the tensor cores read ---------------

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``split_tf32``'s hi: the nearest tf32, ties away from zero."""
    bits = x.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = ((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """An f32 value as a tf32 operand reads it: its top 19 bits."""
    return (x.float().view(torch.int32) & -0x2000).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as ``tf32x3_ss`` / ``tf32x3_rs`` take it: both split into hi
    and lo (lo read truncated), three products, small terms first."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_trunc(a - a_hi), tf32_trunc(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product: both operands rounded to tf32."""
    return tf32_rna(a) @ tf32_rna(b)


def _tile(x: torch.Tensor, r0: int, rows: int = BT) -> torch.Tensor:
    """Rows [r0, r0 + 64) along the sequence dim (-2) of a (..., S, D)
    tensor, zero past its end (the cp.async zero-fill)."""
    out = x.new_zeros(x.shape[:-2] + (rows, x.shape[-1]))
    part = x[..., r0:r0 + rows, :]
    out[..., :part.shape[-2], :] = part
    return out


def _rows(x: torch.Tensor, r0: int) -> torch.Tensor:
    """Rows [r0, r0 + 64) of a (..., S) tensor, zero past its end."""
    return _tile(x[..., None], r0)[..., 0]


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, KH, D) -> (B, h, S, D), KV head kh given to heads kh * G
    .. kh * G + G - 1 (GQA h -> h // G)."""
    x = x.permute(0, 2, 1, 3)
    return x.repeat_interleave(h // x.shape[1], dim=1)


def _kept(qpos: torch.Tensor, kpos: torch.Tensor, skv: int, causal: bool,
          window: int) -> torch.Tensor:
    """(rows, keys) bool: the kernels' ``kept`` for absolute positions."""
    ok = (kpos[None, :] < skv).expand(qpos.shape[0], -1).clone()
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        ok &= kpos[None, :] > qpos[:, None] - window
    return ok


def _kv_band(q0: int, sq: int, skv: int, causal: bool, window: int,
             q_offset: int) -> range:
    """The key tiles a query tile walks (flash_tf32x3_fwd, ..._dq)."""
    qa0 = q_offset + q0
    qa_last = q_offset + min(q0 + BT, sq) - 1
    end = min(skv, qa_last + 1) if causal else skv
    begin = max(0, qa0 - window + 1) if window > 0 else 0
    return range(begin - begin % BT, end, BT)


def _q_band(k0: int, sq: int, skv: int, causal: bool, window: int,
            q_offset: int) -> range:
    """The query tiles a key tile walks (flash_bwd_tf32x3_dkdv)."""
    k_last = min(k0 + BT, skv) - 1
    begin = k0 - q_offset if causal and k0 > q_offset else 0
    end = sq
    if window > 0:
        end = min(end, k_last + window - q_offset)
    return range(begin - begin % BT, end, BT)


def emulate_fwd(q, k, v, causal=True, window=0, q_offset=0, mm=mm3):
    """(o, lse) as flash_tf32x3_fwd computes them: per 64-row query tile
    (every batch and head at once, each its own block on the card) the
    band's key tiles in order, S = Q K^T and O += P V through ``mm``,
    masked scores dropped by a select, the running max and sum in f32 with
    exp2 of log2(e)-scaled scores; a row with no key 0."""
    B, Sq, H, Dk = q.shape
    Skv, Dv = k.shape[1], v.shape[3]
    scale = 1.0 / math.sqrt(Dk)
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    qh, kh, vh = q.permute(0, 2, 1, 3), _heads(k, H), _heads(v, H)
    o = torch.zeros((B, H, Sq, Dv))
    lse = torch.zeros((B, H, Sq))
    for q0 in range(0, Sq, BT):
        qt = _tile(qh, q0)
        qpos = q_offset + q0 + torch.arange(BT)
        m = torch.full((B, H, BT), -1e30)
        ell = torch.zeros((B, H, BT))
        acc = torch.zeros((B, H, BT, Dv))
        for k0 in _kv_band(q0, Sq, Skv, causal, window, q_offset):
            s = mm(qt, _tile(kh, k0).transpose(-1, -2))
            keep = _kept(qpos, k0 + torch.arange(BT), Skv, causal, window)
            s = torch.where(keep, s, torch.tensor(-1e30))
            mx = torch.maximum(m, s.max(-1).values)
            corr = torch.exp2((m - mx) * sl2)
            p = torch.where(keep, torch.exp2(s * sl2 - (mx * sl2)[..., None]),
                            torch.tensor(0.0))
            ell = ell * corr + p.sum(-1)
            m = mx
            acc = acc * corr[..., None] + mm(p, _tile(vh, k0))
        rows = min(BT, Sq - q0)
        o[:, :, q0:q0 + rows] = (acc / ell.clamp(min=1e-30)[..., None]
                                 )[:, :, :rows]
        lse[:, :, q0:q0 + rows] = torch.where(
            ell > 0, m * scale + torch.log(ell.clamp(min=1e-30)),
            torch.tensor(-1e30))[:, :, :rows]
    return o.permute(0, 2, 1, 3), lse


def emulate_bwd(q, k, v, o, do, lse, causal=True, window=0, q_offset=0,
                mm=mm3):
    """(dq, dk, dv) as the three kernels compute them: D = rowsum(dO o O);
    per (64-key tile, KV head) the group's heads and the band's query tiles
    in order, S^T, dP^T, P^T (exp2, a select), dV += P^T dO, dS^T = P^T o
    (dP^T - D) with P^T = hi + lo, dK += dS^T Q; per (64-query tile, head)
    the band's key tiles, S, dP, dS, dQ += dS K; every product through
    ``mm``.  Every batch and head (KV head in the dK/dV kernel) at once,
    each its own block on the card."""
    B, Sq, H, Dk = q.shape
    Skv, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KH
    scale = 1.0 / math.sqrt(Dk)
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    qh, doh = q.permute(0, 2, 1, 3), do.permute(0, 2, 1, 3)
    D = (do * o).sum(-1).permute(0, 2, 1)                 # (B, H, Sq)
    dq = torch.zeros((B, H, Sq, Dk))
    dk = torch.zeros((B, KH, Skv, Dk))
    dv = torch.zeros((B, KH, Skv, Dv))

    def p_of(s, lse_rows, keep):
        return torch.where(keep, torch.exp2(s * sl2 - lse_rows * LOG2E),
                           torch.tensor(0.0))

    kk, vk = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)   # (B, KH, S, D)
    for k0 in range(0, Skv, BT):
        kt, vt = _tile(kk, k0), _tile(vk, k0)
        kpos = k0 + torch.arange(BT)
        acc_k = torch.zeros((B, KH, BT, Dk))
        acc_v = torch.zeros((B, KH, BT, Dv))
        for g in range(G):            # head kh * G + g of each KV head kh
            for q0 in _q_band(k0, Sq, Skv, causal, window, q_offset):
                qt, dot = _tile(qh[:, g::G], q0), _tile(doh[:, g::G], q0)
                lq = _rows(lse[:, g::G], q0)
                dq_ = _rows(D[:, g::G], q0)
                qi = q0 + torch.arange(BT)
                keep = (_kept(q_offset + qi, kpos, Skv, causal, window)
                        & (qi < Sq)[:, None]).T         # (keys, queries)
                pt = p_of(mm(kt, qt.transpose(-1, -2)), lq[..., None, :],
                          keep)
                dpt = mm(vt, dot.transpose(-1, -2))
                acc_v += mm(pt, dot)
                hi = tf32_rna(pt)
                acc_k += mm((hi + (pt - hi)) * (dpt - dq_[..., None, :]), qt)
        rows = min(BT, Skv - k0)
        dk[:, :, k0:k0 + rows] = (scale * acc_k)[:, :, :rows]
        dv[:, :, k0:k0 + rows] = acc_v[:, :, :rows]
    kh, vh = _heads(k, H), _heads(v, H)
    for q0 in range(0, Sq, BT):
        qt, dot = _tile(qh, q0), _tile(doh, q0)
        lq, dq_ = _rows(lse, q0), _rows(D, q0)
        qi = q0 + torch.arange(BT)
        acc = torch.zeros((B, H, BT, Dk))
        for k0 in _kv_band(q0, Sq, Skv, causal, window, q_offset):
            kt, vt = _tile(kh, k0), _tile(vh, k0)
            keep = (_kept(q_offset + qi, k0 + torch.arange(BT), Skv, causal,
                          window) & (qi < Sq)[:, None])
            p = p_of(mm(qt, kt.transpose(-1, -2)), lq[..., None], keep)
            acc += mm(p * (mm(dot, vt.transpose(-1, -2)) - dq_[..., None]),
                      kt)
        rows = min(BT, Sq - q0)
        dq[:, :, q0:q0 + rows] = (scale * acc)[:, :, :rows]
    return tuple(x.permute(0, 2, 1, 3) for x in (dq, dk, dv))


# ---- shapes: the head dims the zoo runs in float32, and the edges --------

CASES = {   # B, Sq, H, KH, Dk, Dv, window, causal, q_offset, Skv
    "hd40-ragged-gqa": (2, 77, 4, 2, 40, 40, 0, True, 0, 77),
    "hd64-gqa-window": (2, 200, 6, 2, 64, 64, 48, True, 0, 200),
    "hd96-64-mla": (1, 130, 4, 4, 96, 64, 0, True, 0, 130),
    "hd128": (1, 140, 4, 2, 128, 128, 0, True, 0, 140),
    "hd160-gqa": (1, 130, 4, 1, 160, 160, 0, True, 0, 130),
    "hd256-window": (1, 100, 2, 1, 256, 256, 40, True, 0, 100),
    "offset-empty-rows": (1, 130, 4, 2, 64, 64, 64, True, 300, 350),
    "offset-noncausal-window": (1, 70, 2, 2, 32, 32, 30, False, 45, 150),
}


def _inputs(case: str, seed: int = 0):
    B, Sq, H, KH, Dk, Dv, window, causal, off, Skv = CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, Sq, H, Dk), (B, Skv, KH, Dk),
                             (B, Skv, KH, Dv), (B, Sq, H, Dv)))
    return (q, k, v, do), dict(causal=causal, window=window, q_offset=off)


def _empty_rows(case: str) -> torch.Tensor:
    """(Sq,) bool: the query rows that keep no key."""
    B, Sq, H, KH, Dk, Dv, window, causal, off, Skv = CASES[case]
    keep = _kept(off + torch.arange(Sq), torch.arange(Skv), Skv, causal,
                 window)
    return ~keep.any(1)


def _jax_forward(q, k, v, causal, window, q_offset):
    """The reference oracle at query positions q_offset + i: its queries
    sit at 0..Sq-1, so ``q_offset`` zero rows go first and are dropped."""
    pad = np.zeros((q.shape[0], q_offset) + q.shape[2:], np.float32)
    out = jax_flash_ref(jnp.asarray(np.concatenate([pad, q], 1)),
                        jnp.asarray(k), jnp.asarray(v), causal=causal,
                        window=window)
    return np.asarray(out, np.float32)[:, q_offset:]


def _violations(got, want, tol) -> int:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return int((np.abs(got - want) > tol + tol * np.abs(want)).sum())


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_emulation_meets_the_float32_gate(case):
    """The forward kernel's arithmetic against the reference oracle at
    2e-5; rows that keep no key are 0 (the oracle gives them a mean of V,
    C0d); the rows' log-sum-exp against the plain version's."""
    (q, k, v, _), mask = _inputs(case)
    o, lse = emulate_fwd(*(torch.from_numpy(x) for x in (q, k, v)), **mask)
    want = _jax_forward(q, k, v, mask["causal"], mask["window"],
                        mask["q_offset"])
    empty = _empty_rows(case).numpy()
    assert _violations(o.numpy()[:, ~empty], want[:, ~empty], K2_GATE) == 0
    assert not o[:, torch.from_numpy(empty)].any()
    _, want_lse = flash_attention_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), return_lse=True, **mask)
    kept = torch.from_numpy(~empty)
    assert _violations(lse[:, :, kept], want_lse[:, :, kept], LSE_TOL) == 0


def test_one_tf32_product_misses_the_forward_gate():
    """Why three products: one TF32 product a matmul (10 mantissa bits)
    breaks the 2e-5 gate at the same shape where three meet it."""
    (q, k, v, _), mask = _inputs("hd64-gqa-window")
    t = [torch.from_numpy(x) for x in (q, k, v)]
    want = _jax_forward(q, k, v, mask["causal"], mask["window"], 0)
    one, _ = emulate_fwd(*t, **mask, mm=mm1)
    three, _ = emulate_fwd(*t, **mask)
    assert _violations(one.numpy(), want, K2_GATE) > 0
    assert _violations(three.numpy(), want, K2_GATE) == 0


def _jax_vjp(q, k, v, do, causal, window, q_offset):
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(
        q_, k_, v_, causal=causal, window=window, kv_chunk=64,
        q_offset=q_offset), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_emulation_meets_the_float32_gate(case):
    """The three backward kernels' arithmetic, given the forward's o and
    lse, against ``jax.vjp`` of the reference model's flash at 1e-4.  dO
    is 0 on rows that keep no key (the reference gives those rows a mean
    of V, whose gradient reaches dv; the kernels write them as 0), and
    their dq is exactly 0."""
    (q, k, v, do), mask = _inputs(case, seed=1)
    empty = _empty_rows(case).numpy()
    do[:, empty] = 0.0
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = emulate_fwd(tq, tk, tv, **mask)
    got = emulate_bwd(tq, tk, tv, o, tdo, lse, **mask)
    want = _jax_vjp(q, k, v, do, mask["causal"], mask["window"],
                    mask["q_offset"])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _violations(g.numpy(), w, K2B_GATE) == 0, name
    assert not got[0][:, torch.from_numpy(empty)].any()


# ---- the register A operand: P's accumulator -> the tf32 A fragment -------

def _accumulator_cell(warp: int, lane: int, reg: int) -> tuple[int, int]:
    """(row, column) of register ``reg`` of an m64nN f32 accumulator
    (sm90_tf32x3.cuh)."""
    i, e = divmod(reg, 4)
    return (16 * warp + lane // 4 + 8 * (e >> 1),
            8 * i + 2 * (lane % 4) + (e & 1))


def _a_fragment_cell(warp: int, lane: int, kk: int, x: int) -> tuple[int, int]:
    """(row, logical k) of register x of the tf32 A fragment of k8 step
    kk: a[0] (g, c), a[1] (g + 8, c), a[2] (g, c + 4), a[3] (g + 8, c + 4)."""
    g, c = 16 * warp + lane // 4, lane % 4
    return g + 8 * (x & 1), 8 * kk + c + 4 * (x >> 1)


def frag_reg(kk: int, x: int) -> int:
    """flash_tf32x3.cuh's frag_reg: the accumulator register that holds
    fragment register x of step kk."""
    return 4 * kk + 2 * (x & 1) + (x >> 1)


def split_t_row(k: int) -> int:
    """split_t's order: logical k of the transposed B chunk -> the chunk's
    row t (16-byte chunk cc = k // 4 holds t = 8 (cc / 2) + 2j + cc % 2)."""
    cc, j = divmod(k, 4)
    return 8 * (cc >> 1) + 2 * j + (cc & 1)


def test_p_fragment_index_map_is_the_permuted_key_rows():
    """Every fragment register takes its value from an accumulator register
    of the same row, and the key that register holds is the row that
    split_t puts at the fragment's logical k: so A (fragments) times B
    (V's rows permuted by split_t) is P V, with no shuffle."""
    seen = set()
    for warp in range(4):
        for lane in range(32):
            for kk in range(8):
                for x in range(4):
                    row_a, k = _a_fragment_cell(warp, lane, kk, x)
                    row_s, key = _accumulator_cell(warp, lane, frag_reg(kk, x))
                    assert row_a == row_s
                    assert split_t_row(k) == key
                    seen.add((row_a, k))
    assert len(seen) == 64 * 64
    assert sorted(split_t_row(k) for k in range(64)) == list(range(64))
    # numerically: the fragments of P and the permuted V give P V
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.standard_normal((64, 64)))
    v = torch.from_numpy(rng.standard_normal((64, 48)))
    a = torch.empty_like(p)
    for warp in range(4):
        for lane in range(32):
            for kk in range(8):
                for x in range(4):
                    row, k = _a_fragment_cell(warp, lane, kk, x)
                    a[row, k] = p[_accumulator_cell(warp, lane,
                                                    frag_reg(kk, x))]
    b = v[[split_t_row(k) for k in range(64)]]
    assert torch.allclose(a @ b, p @ v, rtol=0, atol=1e-12)


# ---- shared memory --------------------------------------------------------

SOURCE_FWD = (_nvcc.CSRC / "flash_attention_tf32x3.cu").read_text()
SOURCE_BWD = (_nvcc.CSRC / "flash_attention_bwd_tf32x3.cu").read_text()


@pytest.mark.parametrize("dk", [1, 40, 64, 65, 96, 128, 160, 192, 256])
def test_tf32x3_shared_memory_fits_a_block(dk):
    for dv in (1, 40, 64, 128, 160, 256):
        assert fa.tf32x3_smem_bytes(dk, dv) <= SMEM_LIMIT
        assert fa.tf32x3_smem_bytes(dk, dv) == fa.tf32x3_smem_bytes(dk, 64)
        assert fa.bwd_tf32x3_smem_bytes(dk, dv) <= SMEM_LIMIT


def test_tf32x3_shared_memory_is_the_sources_figure():
    """The wrapper's figures are the ones the sources' headers state."""
    for dk, want in ((64, 99_328), (128, 132_096), (160, 164_864),
                     (256, 197_632)):
        assert fa.tf32x3_smem_bytes(dk, dk) == want
        assert f"{want:,}" in SOURCE_FWD
    assert fa.tf32x3_smem_bytes(1, 1) == fa.tf32x3_smem_bytes(64, 64)
    for dk, dv, want in ((64, 64, 133_120), (96, 64, 165_888),
                         (128, 128, 198_656), (160, 160, 133_120),
                         (256, 256, 133_120)):
        assert fa.bwd_tf32x3_smem_bytes(dk, dv) == want
        assert f"{want:,}" in SOURCE_BWD
    assert max(fa.tf32x3_smem_bytes(d, d) for d in range(1, 257)) <= \
        SMEM_LIMIT
    assert re.search(r"poas_flash_tf32x3_smem", SOURCE_FWD)
    assert re.search(r"poas_flash_bwd_tf32x3_smem", SOURCE_BWD)


# ---- the route rule and the launch counts ---------------------------------

def test_route_rule_over_every_head_dim():
    """float32 -> tf32x3 at every head dim; bf16 -> sm90 at multiples of 16
    up to 256, else simt; the backward's rule is the forward's."""
    for dk in range(1, 257):
        for dv in (1, 8, 16, 40, 64, 96, 160, 256):
            assert fa.route(torch.float32, dk, dv) == "tf32x3"
            want = "sm90" if dk % 16 == 0 and dv % 16 == 0 else "simt"
            assert fa.route(torch.bfloat16, dk, dv) == want, (dk, dv)
            for dt in (torch.float32, torch.bfloat16):
                assert fa.route_bwd(dt, dk, dv) == fa.route(dt, dk, dv)
    assert fa.ROUTES == ("sm90", "tf32x3", "simt")


def _counts():
    return [getattr(fn, name) for fn in (flash_attention, flash_attention_bwd)
            for name in ("launches", "launches_sm90", "launches_tf32x3",
                         "launches_simt")]


@pytest.mark.parametrize("dtype,dk,dv", [
    (torch.float32, 64, 64), (torch.float32, 40, 24),
    (torch.bfloat16, 64, 64), (torch.bfloat16, 40, 40)])
def test_cpu_calls_count_no_launch_on_any_route(dtype, dk, dv):
    """The plain versions run on CPU tensors: forward, backward and the
    autograd chain count nothing on any of the three routes."""
    before = _counts()
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.standard_normal((1, 70, 2, dk)).astype(
        np.float32)).to(dtype) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((1, 70, 2, dv)).astype(
        np.float32)).to(dtype)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_attention(*leaves, window=16).sum().backward()
    o, lse = flash_attention_ref(q, k, v, return_lse=True)
    flash_attention_bwd(q, k, v, o, o, lse)
    assert _counts() == before


def test_reset_counts_zeroes_all_eight():
    for fn in (flash_attention, flash_attention_bwd):
        fn.launches_tf32x3 += 2
        fn.launches += 2
    fa.reset_counts()
    assert _counts() == [0] * 8


class _ReportsCuda:
    """A CPU tensor that reports a CUDA device (the wrapper's CUDA branch
    on a machine with no card)."""
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_tf32x3_raises_without_a_card(monkeypatch, tmp_path):
    """No fallback: float32 on a CUDA tensor loads the tf32x3 sources (the
    forward's and the backward's) and raises when they cannot be built,
    never reaching simt's, and counts nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr("repro_torch.kernels._nvcc.BUILD_DIR", tmp_path)
    monkeypatch.setattr("repro_torch.kernels._nvcc._libs", {})
    loaded, load = [], _nvcc.load

    def spy(src, entries):
        loaded.append(src)
        return load(src, entries)

    monkeypatch.setattr(_nvcc, "load", spy)
    before = _counts()
    x = _ReportsCuda(torch.ones(1, 8, 2, 40))
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(RuntimeError, match="nvcc"):
        fa._forward(x, x, x, True, 0, None, False)
    with pytest.raises(RuntimeError, match="nvcc"):
        fa._backward(x, x, x, x, x, lse, True, 0, None)
    assert loaded == [fa.SOURCE_TF32X3, fa.SOURCE_BWD_TF32X3]
    assert _counts() == before


def test_aligned16_pads_ragged_float32_rows():
    """The tensor-core kernels copy 16-byte rows: float32 rows of 38
    values come back in a padded buffer (strides multiples of 4, rows on
    16 bytes) holding the same values; aligned rows are not copied."""
    x = torch.arange(2 * 9 * 3 * 38, dtype=torch.float32).view(2, 9, 3, 38)
    fixed = fa._aligned16(x)
    assert fixed is not x and torch.equal(fixed, x)
    assert fixed.data_ptr() % 16 == 0
    assert all(st % 4 == 0 for st in fixed.stride()[:3])
    ok = torch.zeros(2, 9, 3, 40)
    assert fa._aligned16(ok) is ok
