"""K2 and K2-bwd with ``q_offset`` (query row i at position ``q_offset + i``,
keys at 0..Skv-1) against the reference model stack's ``flash_attention(...,
q_offset=)`` (``src/repro/models/layers.py:90``) and its ``jax.vjp``, on
the CPU, where the port's wrappers run their plain versions; the CUDA
kernels are held against the same plain versions at offsets on the card by
``chip_smoke.py``.

Inputs are made with numpy from a seed and handed to both packages: GQA
(4 query heads over 2 KV heads), MLA's head dims Dk 96 / Dv 64, offsets 1,
37 and 200, window 0 and 16, causal and not, with ``Skv = q_offset + Sq``
(chunked prefill's shape) and ``Skv > q_offset + Sq`` (keys after the last
query, which the causal mask drops).  Tolerances: float32 at the K2 tests'
2e-5 forward and 1e-4 backward (``tests/test_torch_kernels_flash.py``,
``tests/test_torch_kernels_bwd.py``); bf16 at 2e-2 (ROADMAP C0c: the model
stack keeps bf16 operands and rounds P, the plain version computes in f32).

Rows that keep no key (ROADMAP C0d): the port's kernels and plain versions
write 0 there, the reference model stack a mean of V over its padded chunk;
such rows are compared with the reference only through what both agree on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.models.layers import flash_attention as jax_flash
from repro_torch.kernels import flash_attention, flash_attention_bwd
from repro_torch.kernels.flash_attention import (attention_bwd_flops,
                                                 attention_flops, band_pairs)
from repro_torch.kernels.ref import (NEG_INF, _band, flash_attention_bwd_ref,
                                     flash_attention_ref)

B, SQ, H, KH, DK, DV = 1, 24, 4, 2, 96, 64
KV_CHUNK = 32
OFFSETS = [1, 37, 200]
WINDOWS = [0, 16]
TAILS = {"chunk": 0, "beyond": 19}     # Skv - (q_offset + Sq)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 2e-2)}


def _inputs(seed, skv, dtype):
    """q, k, v, dO as JAX arrays and torch tensors of one dtype."""
    jdt, tdt = DTYPES[dtype][:2]
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((B, SQ, H, DK), (B, skv, KH, DK), (B, skv, KH, DV),
                    (B, SQ, H, DV))]
    return ([jnp.asarray(x).astype(jdt) for x in xs],
            [torch.from_numpy(x).to(tdt) for x in xs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _jax_vjp(jq, jk, jv, jdo, causal, window, q_offset):
    out, vjp = jax.vjp(lambda a, b, c: jax_flash(
        a, b, c, causal=causal, window=window, kv_chunk=KV_CHUNK,
        q_offset=q_offset), jq, jk, jv)
    return out, vjp(jdo)


CASES = [(off, w, c, t) for off in OFFSETS for w in WINDOWS
         for c in (True, False) for t in TAILS]
IDS = [f"off{off}-w{w}-{'causal' if c else 'noncausal'}-{t}"
       for off, w, c, t in CASES]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("q_offset, window, causal, tail", CASES, ids=IDS)
def test_forward_and_grads_match_the_model_stack(q_offset, window, causal,
                                                 tail, dtype):
    """The autograd Function (plain forward with lse, plain backward) gives
    the reference model flash's output and its ``jax.vjp`` gradients.
    Every row keeps a key here (Skv >= q_offset + Sq)."""
    skv = q_offset + SQ + TAILS[tail]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(q_offset + window, skv,
                                                   dtype)
    assert bool(_band(SQ, skv, causal, window, "cpu", q_offset).any(-1)
                .all())
    want_o, want = _jax_vjp(jq, jk, jv, jdo, causal, window, q_offset)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    o = flash_attention(*leaves, causal=causal, window=window,
                        q_offset=q_offset)
    assert o.dtype == tq.dtype and tuple(o.shape) == (B, SQ, H, DV)
    o.backward(tdo)
    _, _, ftol, btol = DTYPES[dtype]
    np.testing.assert_allclose(_np(o), _np(want_o), rtol=ftol, atol=ftol)
    for name, t, w in zip("qkv", leaves, want):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(_np(t.grad), _np(w), rtol=btol, atol=btol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("q_offset, window, causal, tail",
                         [c for c in CASES if c[3] == "beyond"],
                         ids=[i for i, c in zip(IDS, CASES)
                              if c[3] == "beyond"])
def test_wrappers_run_the_plain_versions(q_offset, window, causal, tail):
    """On CPU tensors the operators are the plain versions, bit for bit,
    and launch nothing."""
    skv = q_offset + SQ + TAILS[tail]
    _, (tq, tk, tv, tdo) = _inputs(7, skv, "float32")
    before = (flash_attention.launches, flash_attention_bwd.launches)
    o = flash_attention(tq, tk, tv, causal=causal, window=window,
                        q_offset=q_offset)
    o2, lse = flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                  return_lse=True, q_offset=q_offset)
    assert torch.equal(o, o2)
    got = flash_attention_bwd(tq, tk, tv, o, tdo, lse, causal=causal,
                              window=window, q_offset=q_offset)
    want = flash_attention_bwd_ref(tq, tk, tv, o, tdo, lse, causal=causal,
                                   window=window, q_offset=q_offset)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (flash_attention.launches, flash_attention_bwd.launches) == before


# ---- q_offset = 0: bit-equal to the plain versions before the offset ----

def _before(q, k, v, causal, window):
    """The plain forward as it stood before ``q_offset``: positions from 0
    for queries and keys alike, masked scores -1e30, one softmax."""
    Sq, Skv = q.shape[1], k.shape[1]
    G = H // KH
    kx = k.float().repeat_interleave(G, dim=2)
    vx = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * (1.0 / DK ** 0.5)
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Skv)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= kp > qp - window
    s = s.masked_fill(~mask, NEG_INF)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vx)
    return o.to(q.dtype), torch.logsumexp(s, dim=-1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", WINDOWS)
def test_offset_zero_is_bit_equal_to_before(window, causal, dtype):
    _, (tq, tk, tv, tdo) = _inputs(3, SQ, dtype)
    want_o, want_lse = _before(tq, tk, tv, causal, window)
    for kw in ({}, {"q_offset": 0}):
        o, lse = flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                     return_lse=True, **kw)
        assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
        assert torch.equal(flash_attention(tq, tk, tv, causal=causal,
                                           window=window, **kw), want_o)
    got = flash_attention_bwd(tq, tk, tv, want_o, tdo, want_lse,
                              causal=causal, window=window, q_offset=0)
    base = flash_attention_bwd(tq, tk, tv, want_o, tdo, want_lse,
                               causal=causal, window=window)
    assert all(torch.equal(g, b) for g, b in zip(got, base))


# ---- rows that keep no key (C0d) ------------------------------------------

EMPTY = {   # q_offset, Skv, causal, window: rows past Skv + window - 1
    "causal-window": (37, 40, True, 16),
    "noncausal-window": (200, 205, False, 16),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(EMPTY))
def test_rows_that_keep_no_key(case, dtype):
    """The plain versions write 0 (lse -1e30) where a row keeps no key, as
    both CUDA routes do, and such a row adds nothing to any gradient.  The
    rows that keep keys equal the model stack's; so do the gradients once
    the empty rows' cotangent is 0 (the model stack spreads such a row over
    its padded chunk's V instead: C0d)."""
    q_offset, skv, causal, window = EMPTY[case]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(11, skv, dtype)
    empty = ~_band(SQ, skv, causal, window, "cpu", q_offset).any(-1)
    assert 0 < int(empty.sum()) < SQ
    o, lse = flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                 return_lse=True, q_offset=q_offset)
    assert bool((o[:, empty] == 0).all())
    assert bool((lse[..., empty] == NEG_INF).all())
    got = flash_attention_bwd_ref(tq, tk, tv, o, tdo, lse, causal=causal,
                                  window=window, q_offset=q_offset)
    assert bool((got[0][:, empty] == 0).all())
    _, _, ftol, btol = DTYPES[dtype]
    keep = np.asarray(~empty)
    jdo0 = jdo * jnp.asarray(keep, jdo.dtype)[None, :, None, None]
    want_o, want = _jax_vjp(jq, jk, jv, jdo0, causal, window, q_offset)
    np.testing.assert_allclose(_np(o)[:, keep], _np(want_o)[:, keep],
                               rtol=ftol, atol=ftol)
    assert np.abs(_np(want_o)[:, ~keep]).max() > 0     # C0d: not 0 there
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=btol, atol=btol,
                                   err_msg=f"d{name}")
    # The cotangent of an empty row changes nothing.
    again = flash_attention_bwd_ref(tq, tk, tv, o, tdo * torch.from_numpy(
        keep)[None, :, None, None].to(tdo.dtype), lse, causal=causal,
        window=window, q_offset=q_offset)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# ---- operations: the flop formulas count the band ------------------------

BANDS = [(sq, skv, c, w, off) for sq, skv in ((24, 24), (24, 61), (64, 20),
                                              (1, 500))
         for c in (True, False) for w in (0, 1, 16) for off in (0, 1, 37, 200)]


@pytest.mark.parametrize("sq, skv, causal, window, q_offset", BANDS)
def test_band_pairs_is_the_band(sq, skv, causal, window, q_offset):
    assert band_pairs(sq, skv, causal, window, q_offset) == \
        int(_band(sq, skv, causal, window, "cpu", q_offset).sum())


@pytest.mark.parametrize("q_offset, window, causal, tail", CASES, ids=IDS)
def test_flop_counter_counts_the_kept_pairs(q_offset, window, causal, tail):
    """``FlopCounterMode`` over the forward and backward at an offset: the
    operators' formulas, each equal to the brute-forced band's pairs."""
    skv = q_offset + SQ + TAILS[tail]
    _, (tq, tk, tv, tdo) = _inputs(5, skv, "float32")
    pairs = int(_band(SQ, skv, causal, window, "cpu", q_offset).sum())
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    with FlopCounterMode(display=False) as fwd:
        o = flash_attention(*leaves, causal=causal, window=window,
                            q_offset=q_offset)
    with FlopCounterMode(display=False) as bwd:
        o.backward(tdo)
    assert fwd.get_total_flops() == 2 * B * H * (DK + DV) * pairs
    assert bwd.get_total_flops() == 2 * B * H * (4 * DK + 3 * DV) * pairs
    shapes = [tuple(x.shape) for x in (tq, tk, tv)]
    assert attention_flops(*shapes, causal, window, None, q_offset) == \
        fwd.get_total_flops()
    assert attention_bwd_flops(*shapes, shapes[0][:3] + (DV,), tuple(
        tdo.shape), (B, H, SQ), causal, window, None, q_offset) == \
        bwd.get_total_flops()


def test_negative_offset_is_refused():
    _, (tq, tk, tv, _) = _inputs(0, SQ, "float32")
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(tq, tk, tv, q_offset=-1)
