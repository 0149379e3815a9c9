"""The gradients of K2 and K3 in the port (``kernels.flash_attention_bwd``,
``kernels.ssd_chunk_bwd`` and the ``torch.autograd.Function``s that K2 and
K3 run as under autograd) on the CPU, where they run their plain versions
(``ref.flash_attention_bwd_ref``, ``ref.ssd_chunk_bwd_ref``); the CUDA
kernels are held against the same plain versions on the card by
``chip_smoke.py``.

The reference takes these gradients with ``jax.vjp`` of the model stack's
``repro.models.layers.flash_attention`` and ``repro.models.ssm.ssd_scan``
(and of the kernels' oracle ``repro.kernels.ref.ssd_chunk_ref``); inputs and
cotangents are made with numpy from a seed and handed to both.  Tolerance
1e-4 (rtol and atol) in float32: the two sides sum in different orders (the
JAX flash scans KV chunks with a running max; the port takes one softmax).
``gradcheck`` holds the plain backwards against finite differences of the
plain forwards in float64.  C3: where the in-chunk decay leaves float32's
range the reference's gradient is NaN and the port's is finite and equal to
a float64 computation that masks before exp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_chunk_ref as jax_ssd_chunk_ref
from repro.models.layers import flash_attention as jax_flash
from repro.models.ssm import ssd_scan as jax_ssd_scan
from repro_torch.kernels import (flash_attention, flash_attention_bwd,
                                 ssd_chunk, ssd_chunk_bwd)
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref, ssd_chunk_bwd_ref,
                                     ssd_chunk_ref)
from repro_torch.models.ssm import ssd_scan

TOL = 1e-4


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               rtol=tol, atol=tol, err_msg=what)


# ------------------------------------------------------------------- K2 --

FLASH = {   # B, S, H, KH, Dk, Dv, causal, window
    "causal-mha": (1, 48, 4, 4, 16, 16, True, 0),
    "gqa-window-ragged": (2, 37, 4, 2, 8, 8, True, 10),
    "noncausal": (2, 24, 4, 4, 8, 8, False, 0),
    "noncausal-window": (1, 30, 2, 1, 8, 8, False, 7),
    "mla-dk-ne-dv": (1, 29, 2, 2, 12, 8, True, 0),
}


def _flash_inputs(case, seed):
    B, S, H, KH, Dk, Dv, causal, window = FLASH[case]
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((B, S, H, Dk), (B, S, KH, Dk), (B, S, KH, Dv),
                    (B, S, H, Dv))]
    return xs, causal, window


def _jax_flash_vjp(q, k, v, do, causal, window):
    out, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(
        q_, k_, v_, causal=causal, window=window, kv_chunk=16),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return out, vjp(jnp.asarray(do))


@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_autograd_matches_jax_vjp(case):
    """The Function (CPU route: plain forward with lse, plain backward)
    gives the reference model flash's output and gradients."""
    (q, k, v, do), causal, window = _flash_inputs(case, 0)
    want_o, want = _jax_flash_vjp(q, k, v, do, causal, window)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = flash_attention_bwd.launches
    o = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert o.grad_fn is not None
    o.backward(torch.from_numpy(do))
    assert flash_attention_bwd.launches == before     # CPU: plain version
    _close(o, want_o, f"{case}: o")
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        _close(t.grad, w, f"{case}: d{name}")


@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_plain_backward_matches_jax_vjp(case):
    (q, k, v, do), causal, window = _flash_inputs(case, 1)
    _, want = _jax_flash_vjp(q, k, v, do, causal, window)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                 return_lse=True)
    assert lse.shape == (tq.shape[0], tq.shape[2], tq.shape[1])
    got = flash_attention_bwd_ref(tq, tk, tv, o, tdo, lse, causal=causal,
                                  window=window)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, f"{case}: d{name}")
    wrapped = flash_attention_bwd(tq, tk, tv, o, tdo, lse, causal=causal,
                                  window=window)
    for g, w in zip(wrapped, got):
        assert torch.equal(g, w)


def test_flash_lse_is_the_rows_logsumexp():
    (q, k, v, _), causal, window = _flash_inputs("gqa-window-ragged", 2)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _, lse = flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                 return_lse=True)
    G = tq.shape[2] // tk.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", tq.double(),
                     tk.double().repeat_interleave(G, 2)) / np.sqrt(8)
    S = tq.shape[1]
    pos = torch.arange(S)
    kept = (pos[:, None] >= pos[None, :]) & (pos[None, :] > pos[:, None]
                                              - window)
    want = torch.logsumexp(s.masked_fill(~kept, -torch.inf), -1)
    torch.testing.assert_close(lse.double(), want, rtol=1e-6, atol=1e-6)


def test_flash_bf16_grads_come_back_in_bf16():
    (q, k, v, do), causal, window = _flash_inputs("mla-dk-ne-dv", 3)
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_()
                  for x in (q, k, v))
    o = flash_attention(tq, tk, tv, causal=causal, window=window)
    o.backward(torch.from_numpy(do).bfloat16())
    assert {t.grad.dtype for t in (tq, tk, tv)} == {torch.bfloat16}


def test_flash_no_grad_saves_nothing():
    """Serving runs without autograd: no graph, so nothing is kept."""
    (q, k, v, _), causal, window = _flash_inputs("causal-mha", 4)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        o = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert o.grad_fn is None
    o2 = flash_attention(*(t.detach() for t in (tq, tk, tv)))
    assert o2.grad_fn is None


class _PlainFlash(torch.autograd.Function):
    """The plain forward with the plain backward (the formulas under
    test), for gradcheck."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                     return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        causal, window = ctx.mask
        return (*flash_attention_bwd_ref(*ctx.saved_tensors[:4], do,
                                         ctx.saved_tensors[4], causal=causal,
                                         window=window), None, None)


@pytest.mark.parametrize("case", ["gqa-window-ragged", "noncausal",
                                  "mla-dk-ne-dv"])
def test_flash_plain_backward_gradcheck_float64(case):
    B, S, H, KH, Dk, Dv, causal, window = FLASH[case]
    S = min(S, 12)
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((B, S, H, Dk), (B, S, KH, Dk), (B, S, KH, Dv)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: _PlainFlash.apply(a, b, c, causal, window),
        (q, k, v), eps=1e-6, atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------------- K3 --

def _ssd_chunk_inputs(seed, b, nc, Q, nh, G, hp, ds, span=1.0):
    rng = np.random.default_rng(seed)
    xdt = (rng.standard_normal((b, nc, Q, nh, hp)) * 0.5).astype(np.float32)
    B = (rng.standard_normal((b, nc, Q, G, ds)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, nc, Q, G, ds)) * 0.5).astype(np.float32)
    cum = np.cumsum(-np.log1p(np.exp(rng.standard_normal((b, nc, Q, nh))))
                    * span, axis=2).astype(np.float32)
    dy = rng.standard_normal((b, nc, Q, nh, hp)).astype(np.float32)
    dst = rng.standard_normal((b, nc, nh, ds, hp)).astype(np.float32)
    return xdt, B, C, cum, dy, dst


SSD = {   # b, NC, Q, nh, G, hp, ds
    "single-group": (1, 2, 8, 4, 1, 8, 4),
    "grouped": (2, 2, 16, 4, 2, 8, 8),
    "ragged-q": (1, 1, 13, 6, 3, 4, 5),
}


@pytest.mark.parametrize("case", sorted(SSD))
def test_ssd_chunk_grads_match_jax_vjp(case):
    """The plain backward and the Function's backward (CPU route) against
    ``jax.vjp`` of the kernels' oracle, with both cotangents."""
    xdt, B, C, cum, dy, dst = _ssd_chunk_inputs(0, *SSD[case])
    _, vjp = jax.vjp(jax_ssd_chunk_ref, *(jnp.asarray(x)
                                          for x in (xdt, B, C, cum)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dst)))
    t = [torch.from_numpy(x) for x in (xdt, B, C, cum, dy, dst)]
    got = ssd_chunk_bwd_ref(*t)
    for name, g, w in zip(("xdt", "B", "C", "cum"), got, want):
        _close(g, w, f"{case}: d{name}")
    leaves = [x.clone().requires_grad_() for x in t[:4]]
    before = ssd_chunk_bwd.launches
    y, states = ssd_chunk(*leaves)
    torch.autograd.backward((y, states), (t[4], t[5]))
    assert ssd_chunk_bwd.launches == before
    for name, x, g in zip(("xdt", "B", "C", "cum"), leaves, got):
        assert torch.equal(x.grad, g), name


def test_ssd_chunk_backward_with_one_cotangent():
    """Only y used: the states' cotangent is zero, not missing."""
    xdt, B, C, cum, dy, _ = _ssd_chunk_inputs(1, *SSD["grouped"])
    leaves = [torch.from_numpy(x).requires_grad_() for x in (xdt, B, C, cum)]
    y, _ = ssd_chunk(*leaves)
    y.backward(torch.from_numpy(dy))
    _, vjp = jax.vjp(jax_ssd_chunk_ref, *(jnp.asarray(x)
                                          for x in (xdt, B, C, cum)))
    want = vjp((jnp.asarray(dy), jnp.zeros((2, 2, 4, 8, 8), jnp.float32)))
    for name, x, w in zip(("xdt", "B", "C", "cum"), leaves, want):
        _close(x.grad, w, f"d{name}")


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_scan_grads_match_jax_vjp(chunk, groups):
    """The whole chunked scan (K3's Function plus the inter-chunk
    recurrence in torch) against ``jax.vjp`` of the reference's ssd_scan,
    at small chunks (where the reference's gradient is finite)."""
    rng = np.random.default_rng(chunk + groups)
    b, S, nh, hp, ds = 2, 37, 4, 8, 4
    xh = rng.standard_normal((b, S, nh, hp)).astype(np.float32)
    B = rng.standard_normal((b, S, groups, ds)).astype(np.float32)
    C = rng.standard_normal((b, S, groups, ds)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, nh)))).astype(
        np.float32) * 0.5
    A = -np.exp(np.linspace(0.0, 1.0, nh)).astype(np.float32)
    dy = rng.standard_normal((b, S, nh, hp)).astype(np.float32)
    dh = rng.standard_normal((b, nh, hp, ds)).astype(np.float32)
    args = (xh, B, C, dt, A)
    want = jax.jit(lambda a, ct: jax.vjp(
        lambda *x: jax_ssd_scan(*x, chunk=chunk), *a)[1](ct))(
        tuple(jnp.asarray(x) for x in args),
        (jnp.asarray(dy), jnp.asarray(dh)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in args]
    y, h = ssd_scan(*leaves, chunk=chunk)
    torch.autograd.backward((y, h), (torch.from_numpy(dy),
                                     torch.from_numpy(dh)))
    for name, x, w in zip(("xh", "B", "C", "dt", "A"), leaves, want):
        _close(x.grad, w, f"chunk {chunk}, G {groups}: d{name}")


class _PlainSsd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xdt, B, C, cum):
        ctx.save_for_backward(xdt, B, C, cum)
        return ssd_chunk_ref(xdt, B, C, cum)

    @staticmethod
    def backward(ctx, dy, dst):
        return ssd_chunk_bwd_ref(*ctx.saved_tensors, dy, dst)


@pytest.mark.parametrize("case", ["grouped", "ragged-q"])
def test_ssd_plain_backward_gradcheck_float64(case):
    b, nc, Q, nh, G, hp, ds = SSD[case]
    ins = [torch.from_numpy(x.astype(np.float64)).requires_grad_()
           for x in _ssd_chunk_inputs(6, 1, 1, min(Q, 9), nh, G, 3, 3)[:4]]
    assert torch.autograd.gradcheck(_PlainSsd.apply, tuple(ins), eps=1e-6,
                                    atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------------- C3 --

def _masked_ssd_scan64(xh, B, C, dt, A, chunk):
    """ssd_scan in float64, masking the decay's difference before exp (the
    formula the port's backward takes), differentiated by autograd."""
    b, S, nh, hp = xh.shape
    G, ds = B.shape[2], B.shape[3]
    hg = nh // G
    NC = S // chunk
    xc = xh.reshape(b, NC, chunk, nh, hp)
    Bc = B.reshape(b, NC, chunk, G, ds).repeat_interleave(hg, 3)
    Cc = C.reshape(b, NC, chunk, G, ds).repeat_interleave(hg, 3)
    dtc = dt.reshape(b, NC, chunk, nh)
    cum = torch.cumsum(dtc * A, dim=2)
    ct = cum.transpose(2, 3)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    L = torch.exp(torch.where(causal, ct[..., :, None] - ct[..., None, :],
                              -torch.inf))
    M = torch.einsum("bnqhs,bnths->bnhqt", Cc, Bc) * L
    xdt = xc * dtc[..., None]
    y = torch.einsum("bnhqt,bnthp->bnqhp", M, xdt)
    w = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bnths,bnthp->bnhps", Bc, xdt * w[..., None])
    h = torch.zeros_like(states[:, 0])
    hs = []
    for c in range(NC):
        hs.append(h)
        h = h * torch.exp(cum[:, c, -1, :])[..., None, None] + states[:, c]
    y = y + torch.einsum("bnths,bnhps->bnthp", Cc, torch.stack(hs, 1)) \
        * torch.exp(cum)[..., None]
    return y.reshape(b, S, nh, hp), h


def test_c3_reference_grad_is_nan_where_the_port_is_finite():
    """At hymba's chunk 256 with its A (-exp(linspace(log 1, log 16))) and
    dt ~ softplus(0) ~ 0.69, cum spans hundreds to thousands inside a chunk:
    exp(cum_q - cum_t) above the diagonal overflows, and the VJP of the
    reference's select-after-exp multiplies a zero cotangent by inf.  The
    port's gradient is finite and equals the float64 masked computation
    (rtol 1e-3, atol 1e-5 relative to each gradient's largest entry: the
    port runs in float32 over 512 positions)."""
    rng = np.random.default_rng(0)
    b, S, nh, hp, ds, chunk = 1, 512, 2, 8, 4, 256
    xh = rng.standard_normal((b, S, nh, hp)).astype(np.float32)
    B = (rng.standard_normal((b, S, 1, ds)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, S, 1, ds)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, S, nh)) * 0.1))
          ).astype(np.float32)
    A = -np.exp(np.linspace(np.log(1.0), np.log(16.0), nh)).astype(
        np.float32)
    dy = rng.standard_normal((b, S, nh, hp)).astype(np.float32)
    args = (xh, B, C, dt, A)

    ref_grads = jax.jit(jax.grad(lambda *a: jnp.sum(
        jax_ssd_scan(*a, chunk=chunk)[0] * jnp.asarray(dy)),
        argnums=(0, 1, 2, 3, 4)))(*(jnp.asarray(x) for x in args))
    assert np.isnan(np.asarray(ref_grads[3])).any()      # d dt is NaN

    leaves = [torch.from_numpy(x).requires_grad_() for x in args]
    y, _ = ssd_scan(*leaves, chunk=chunk)
    y.backward(torch.from_numpy(dy))
    want_leaves = [torch.from_numpy(x).double().requires_grad_()
                   for x in args]
    y64, _ = _masked_ssd_scan64(*want_leaves, chunk=chunk)
    y64.backward(torch.from_numpy(dy).double())
    for name, got, want in zip(("xh", "B", "C", "dt", "A"), leaves,
                               want_leaves):
        assert torch.isfinite(got.grad).all(), name
        scale = float(want.grad.abs().max())
        np.testing.assert_allclose(got.grad.double().numpy(),
                                   want.grad.numpy(), rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=f"d{name}")
