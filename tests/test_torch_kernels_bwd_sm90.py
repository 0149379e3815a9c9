"""The tensor-core backward kernels of the port on the CPU: K2-bwd's bf16
``sm90`` route and K3-bwd's 3xTF32 route.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against their plain versions.  Here:

* K2-bwd rounds P and dS to bf16 as MMA operands.  Its plain "want" on the
  card is ``flash_attention_bwd_ref(..., round_to=torch.bfloat16)``, which
  rounds at the same places.  That emulation is held against ``jax.vjp`` of
  the reference model's ``flash_attention`` in bf16 and against the float32
  plain backward, at a relative norm of 1e-2 per output: the reference's
  own bf16 gradient differs from the float32 plain backward by 2-4e-3 (its
  flash rounds P to V's dtype before P V, src/repro/models/layers.py
  :143-146), and the emulation is no further off than that.
* ``route_bwd`` at every head-dim pair ``chip_smoke.py`` phase 7 (a) runs,
  and over every pair of multiples of 16 up to 256 (``route``'s rule).
* The sm90 source's shared memory per (Dk, Dv) by the wrapper's mirror of
  its rule: within a block's 232,448 bytes at every pair the route takes,
  and the figures the source states.
* K3-bwd's algorithm in torch: every product as the kernel takes it
  through 3xTF32 (hi/lo split, three TF32 products), dCB summed over each
  head slice and the slices summed before dC = dCB B and dB = dCB^T C, held
  against ``ssd_chunk_bwd_ref`` (and the reference's ``jax.vjp``) at 1e-4;
  one TF32 pass of the same algorithm misses that gate.
* K3-bwd's shared-memory, slice and scratch rules against the figures its
  source states, and both sources issue wgmma with no CUDA-core product
  loop.

Inputs are made with numpy from a seed and handed to both packages.
"""
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_chunk_ref as jax_ssd_chunk_ref
from repro.models.layers import flash_attention as jax_flash
from repro_torch.kernels import _nvcc, flash_attention_bwd
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref, ssd_chunk_bwd_ref)

fa = importlib.import_module("repro_torch.kernels.flash_attention")
sc = importlib.import_module("repro_torch.kernels.ssd_chunk")

NORM = 1e-2          # relative norm per output, bf16 (see the docstring)
K3_GATE = 1e-4       # tests/test_kernels_ssd.py:34


def _rel_norm(got, want) -> float:
    got = torch.from_numpy(np.array(got, np.float32))
    want = torch.from_numpy(np.array(want, np.float32))
    return float((got - want).norm() / want.norm())


def _violations(got, want, tol) -> int:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return int((np.abs(got - want) > tol + tol * np.abs(want)).sum())


# ---- K2-bwd: the bf16 rounding emulation ----------------------------------

FLASH_BF16 = {   # B, S, H, KH, Dk, Dv, window
    "gqa-window": (1, 256, 4, 1, 32, 32, 64),
    "gqa-window-ragged": (2, 77, 4, 2, 16, 16, 20),
    "mha-full-ragged": (1, 130, 2, 2, 32, 32, 0),
    # head dims in (128, 256]: the sm90 route's two-warpgroup kernels
    "gqa4-160": (1, 128, 8, 2, 160, 160, 0),
    "dk192-dv128-window-ragged": (2, 77, 4, 2, 192, 128, 20),
    "d256-window-ragged": (1, 130, 4, 2, 256, 256, 32),
}


def _bf16_inputs(case, seed):
    """q, k, v, dO as bf16 tensors, from numpy normals of a seed."""
    B, S, H, KH, Dk, Dv, window = FLASH_BF16[case]
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          .bfloat16() for s in ((B, S, H, Dk), (B, S, KH, Dk),
                                (B, S, KH, Dv), (B, S, H, Dv))]
    return xs, window


def _emulation(q, k, v, do, window):
    o, lse = flash_attention_ref(q, k, v, window=window, return_lse=True)
    return flash_attention_bwd_ref(q, k, v, o, do, lse, window=window,
                                   round_to=torch.bfloat16), o, lse


@pytest.mark.parametrize("case", sorted(FLASH_BF16))
def test_k2_bf16_emulation_matches_jax_vjp(case):
    (q, k, v, do), window = _bf16_inputs(case, 0)
    got, _, _ = _emulation(q, k, v, do, window)
    as_jax = [jnp.asarray(x.float().numpy(), jnp.bfloat16)
              for x in (q, k, v, do)]
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=True,
                                               window=window, kv_chunk=64),
                     *as_jax[:3])
    want = vjp(as_jax[3])
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        assert _rel_norm(g.float().numpy(), w.astype(jnp.float32)) <= NORM, \
            f"{case}: d{name}"


@pytest.mark.parametrize("case", sorted(FLASH_BF16))
def test_k2_bf16_emulation_is_near_the_f32_backward(case):
    """The rounding moves each output by a few 1e-3 of its norm: inside
    1e-2, and not nothing (P and dS really are rounded)."""
    (q, k, v, do), window = _bf16_inputs(case, 1)
    got, o, lse = _emulation(q, k, v, do, window)
    want = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                   o.float(), do.float(), lse,
                                   window=window)
    unrounded = flash_attention_bwd_ref(q, k, v, o, do, lse, window=window)
    for name, g, w, u in zip("qkv", got, want, unrounded):
        norm = _rel_norm(g.float().numpy(), w.numpy())
        assert 1e-4 < norm <= NORM, f"{case}: d{name} {norm}"
        assert not torch.equal(g, u), f"{case}: d{name} was not rounded"


def test_k2_round_to_none_is_the_plain_backward():
    (q, k, v, do), window = _bf16_inputs("gqa-window-ragged", 2)
    o, lse = flash_attention_ref(q, k, v, window=window, return_lse=True)
    plain = flash_attention_bwd_ref(q, k, v, o, do, lse, window=window)
    again = flash_attention_bwd_ref(q, k, v, o, do, lse, window=window,
                                    round_to=None)
    for a, b in zip(plain, again):
        assert torch.equal(a, b)


# ---- K2-bwd: the route rule ------------------------------------------------

@pytest.mark.parametrize("dk,dv,bf16_route", [
    (64, 64, "sm90"),       # hymba-1.5B, the training path
    (32, 32, "sm90"),
    (96, 64, "sm90"),       # MLA-like Dk != Dv
    (160, 160, "sm90"),     # stablelm's 160: the two-warpgroup kernels
    (40, 40, "simt"),       # not a multiple of 16
    (128, 128, "sm90"),     # the largest of the one-warpgroup kernels
    (16, 16, "sm90"),
    (144, 144, "sm90"),
    (8, 8, "simt"),
    (256, 256, "sm90"),     # the largest the sm90 kernels take
    (192, 128, "sm90"),     # Dk != Dv above 128
    (272, 272, "simt"),     # past MAX_HEAD_DIM
])
def test_route_bwd(dk, dv, bf16_route):
    assert fa.route_bwd(torch.bfloat16, dk, dv) == bf16_route
    assert fa.route_bwd(torch.float32, dk, dv) == "tf32x3"


def test_route_bwd_is_the_forward_rule():
    """bf16 with Dk and Dv multiples of 16 up to MAX_HEAD_DIM (256) take
    sm90, any other bf16 head dim takes simt and float32 takes tf32x3: the
    forward's ``route``, with no separate backward limit left."""
    assert fa.MAX_HEAD_DIM == 256
    assert not hasattr(fa, "MAX_HEAD_DIM_BWD_SM90")
    for dk in range(1, 273):
        for dv in (16, 40, 160, 256, 272):
            want = ("sm90" if dk % 16 == 0 and dv % 16 == 0
                    and dk <= 256 and dv <= 256 else "simt")
            assert fa.route_bwd(torch.bfloat16, dk, dv) == want, (dk, dv)
            assert fa.route_bwd(torch.bfloat16, dk, dv) == fa.route(
                torch.bfloat16, dk, dv)
            assert fa.route_bwd(torch.float32, dk, dv) == "tf32x3"


# ---- K2-bwd: the sm90 source's shared memory --------------------------------

K2B_SOURCE = (_nvcc.CSRC / "flash_attention_bwd_sm90.cu").read_text()


def test_k2_bwd_shared_memory_fits_a_block_at_every_sm90_pair():
    pairs = [(dk, dv) for dk in range(16, 257, 16) for dv in range(16, 257, 16)]
    assert len(pairs) == 256
    for dk, dv in pairs:
        assert fa.route_bwd(torch.bfloat16, dk, dv) == "sm90"
        assert fa.bwd_sm90_smem_bytes(dk, dv) <= sc.SMEM_LIMIT, (dk, dv)
    assert sc.SMEM_LIMIT == 232_448     # a block's shared memory on the H100
    assert max(fa.bwd_sm90_smem_bytes(*p) for p in pairs) == 230_400


@pytest.mark.parametrize("dk,dv,want", [
    (64, 64, 51_200),       # hymba: K, V and two stages of Q, dO, lse, D
    (96, 64, 75_776),       # MLA
    (128, 128, 100_352),    # dbrx, llama4, internvl2: the dK/dV kernel
    (160, 160, 165_888),    # stablelm: NB = 3, the two-warpgroup dK/dV
    (192, 128, 165_888),    # both dims at the larger count
    (144, 144, 165_888),
    (256, 256, 230_400),    # NB = 4: the two-warpgroup dQ, P and dS tiles
    (64, 256, 230_400),
])
def test_k2_bwd_shared_memory_is_the_source_figure(dk, dv, want):
    assert fa.bwd_sm90_smem_bytes(dk, dv) == want
    if want >= 100_352:
        assert f"{want:,}" in K2B_SOURCE


def test_cpu_backward_counts_no_launch_and_reset_zeroes_six():
    (q, k, v, do), window = _bf16_inputs("gqa-window-ragged", 3)
    o, lse = flash_attention_ref(q, k, v, window=window, return_lse=True)
    counts = (flash_attention_bwd.launches, flash_attention_bwd.launches_sm90,
              flash_attention_bwd.launches_simt)
    flash_attention_bwd(q, k, v, o, do, lse, window=window)
    assert (flash_attention_bwd.launches, flash_attention_bwd.launches_sm90,
            flash_attention_bwd.launches_simt) == counts
    fa.flash_attention_bwd.launches_sm90 = 3
    fa.flash_attention.launches_simt = 2
    fa.reset_counts()
    for fn in (fa.flash_attention, fa.flash_attention_bwd):
        assert fn.launches == fn.launches_sm90 == fn.launches_simt == 0


# ---- K3-bwd: 3xTF32 and the per-group dCB sum ----------------------------

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` (``split_tf32``'s hi in csrc/sm90_tf32x3.cuh)."""
    bits = x.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = ((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """An f32 value as a tf32 operand reads it: its top 19 bits."""
    return (x.float().view(torch.int32) & -0x2000).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three TF32 products of the hi/lo splits, small terms first."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_trunc(a - a_hi), tf32_trunc(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 pass: both operands rounded to tf32."""
    return tf32_rna(a) @ tf32_rna(b)


def ssd_bwd_tensor_cores(xdt, B, C, cum, dy, dst, hs, mm=mm3, tile=64):
    """K3-bwd as its three kernels compute it, every product through
    ``mm``: per (t tile j <= q tile i) pair, C B^T once per group (as
    B_t C_q^T), dM^T = xdt_t dy_q^T and dxdt += M^T dy_q per head, dCB^T
    summed over each slice of ``hs`` heads; the state terms per head; then
    the slices' dCB^T summed in slice order before dB += dCB^T C_i and
    dC += dCB B_j, once per group.  (b, NC) are batch dims throughout."""
    b, nc, Q, nh, hp = xdt.shape
    G, ds = B.shape[3], B.shape[4]
    hg = nh // G
    slices = -(-hg // hs)
    x = xdt.permute(0, 1, 3, 2, 4)                    # (b, nc, nh, Q, hp)
    y = dy.permute(0, 1, 3, 2, 4)
    Bg = B.permute(0, 1, 3, 2, 4)                     # (b, nc, G, Q, ds)
    Cg = C.permute(0, 1, 3, 2, 4)
    cm = cum.permute(0, 1, 3, 2)                      # (b, nc, nh, Q)
    w = torch.exp(cm[..., -1:] - cm)                  # (b, nc, nh, Q)
    dxdt = torch.zeros_like(x)
    dct = torch.zeros_like(cm)
    dcq = torch.zeros_like(cm)
    dcb = {}                                          # (j, i) -> slices
    head_group = torch.arange(nh) // hg
    for j in range(0, Q, tile):
        t = slice(j, min(j + tile, Q))
        for i in range(j, Q, tile):
            q = slice(i, min(i + tile, Q))
            cbt = mm(Bg[:, :, :, t], Cg[:, :, :, q].transpose(-1, -2))
            dmt = mm(x[:, :, :, t], y[:, :, :, q].transpose(-1, -2))
            tt = torch.arange(t.start, t.stop)[:, None]
            qq = torch.arange(q.start, q.stop)[None, :]
            keep = qq >= tt
            dec = torch.where(keep, torch.exp(torch.where(
                keep, cm[..., q][..., None, :] - cm[..., t][..., :, None],
                torch.zeros(()))), torch.zeros(()))
            dm = torch.where(keep, dmt, torch.zeros(()))
            mt = cbt[:, :, head_group] * dec
            e = dm * mt
            dct[..., t] -= e.sum(-1)
            dcq[..., q] += e.sum(-2)
            dxdt[:, :, :, t] += mm(mt, y[:, :, :, q])
            part = (dm * dec).reshape(b, nc, G, hg, *dm.shape[-2:])
            dcb[(j, i)] = [part[:, :, :, s * hs:(s + 1) * hs].sum(3)
                           for s in range(slices)]
    # State terms, per head.
    dst_g = dst                                        # (b, nc, nh, ds, hp)
    Bh = Bg[:, :, head_group]                          # (b, nc, nh, Q, ds)
    g_state = w[..., None] * mm(x, dst_g.transpose(-1, -2))   # (.., Q, ds)
    dxdt += mm(w[..., None] * Bh, dst_g)
    f = (Bh * g_state).sum(-1)                         # (b, nc, nh, Q)
    dct -= f
    dcq[..., -1] += f.sum(-1)
    state_db = g_state.reshape(b, nc, G, hg, Q, ds)
    state_db = sum(state_db[:, :, :, s * hs:(s + 1) * hs].sum(3)
                   for s in range(slices))
    # Post: dB and dC once per group from the slices' summed dCB.
    dBg = state_db.clone()
    dCg = torch.zeros_like(Cg)
    for (j, i), parts in dcb.items():
        d = parts[0]
        for p in parts[1:]:
            d = d + p
        t = slice(j, min(j + tile, Q))
        q = slice(i, min(i + tile, Q))
        dBg[:, :, :, t] += mm(d, Cg[:, :, :, q])
        dCg[:, :, :, q] += mm(d.transpose(-1, -2), Bg[:, :, :, t])
    return (dxdt.permute(0, 1, 3, 2, 4), dBg.permute(0, 1, 3, 2, 4),
            dCg.permute(0, 1, 3, 2, 4), (dct + dcq).permute(0, 1, 3, 2))


def _ssd_inputs(seed, b, nc, Q, nh, G, hp, ds):
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((b, nc, Q, nh, hp)).astype(np.float32) * 0.5
    B = rng.standard_normal((b, nc, Q, G, ds)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, nc, Q, G, ds)).astype(np.float32) * 0.5
    cum = np.cumsum(-np.logaddexp(rng.standard_normal((b, nc, Q, nh)), 0.0)
                    .astype(np.float32), axis=2).astype(np.float32)
    dy = rng.standard_normal((b, nc, Q, nh, hp)).astype(np.float32)
    dst = rng.standard_normal((b, nc, nh, ds, hp)).astype(np.float32)
    return xdt, B, C, cum, dy, dst


@pytest.mark.parametrize("shape,hs", [
    ((1, 1, 256, 6, 1, 64, 16), 4),    # hymba's chunk; slices of 4 and 2
    ((1, 2, 100, 4, 2, 32, 16), 1),    # ragged Q, two groups, a head a slice
    ((2, 1, 130, 4, 2, 16, 20), 2),    # three ragged tiles, ds off the grid
])
def test_k3_bwd_tf32x3_meets_the_f32_gate(shape, hs):
    arrays = _ssd_inputs(0, *shape)
    ts = [torch.from_numpy(a) for a in arrays]
    got = ssd_bwd_tensor_cores(*ts, hs=hs)
    want = ssd_chunk_bwd_ref(*ts)
    for name, g, w in zip(("dxdt", "dB", "dC", "dcum"), got, want):
        assert _violations(g.numpy(), w.numpy(), K3_GATE) == 0, name


def test_k3_bwd_tf32x3_matches_jax_vjp_at_a_finite_chunk():
    """At a chunk short enough that the reference's decay stays finite
    (ROADMAP C3), the emulation is also the reference's own gradient."""
    arrays = _ssd_inputs(3, 1, 2, 50, 4, 2, 16, 8)
    got = ssd_bwd_tensor_cores(*(torch.from_numpy(a) for a in arrays), hs=1)
    xdt, B, C, cum, dy, dst = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(jax_ssd_chunk_ref, xdt, B, C, cum)
    for name, g, w in zip(("dxdt", "dB", "dC", "dcum"), got,
                          vjp((dy, dst))):
        assert np.isfinite(np.asarray(w)).all(), name
        assert _violations(g.numpy(), np.asarray(w), K3_GATE) == 0, name


def test_k3_bwd_one_tf32_pass_misses_the_gate():
    """Why K3-bwd splits every product: one TF32 pass of the same
    algorithm misses 1e-4 at hymba's chunk shape."""
    ts = [torch.from_numpy(a) for a in _ssd_inputs(1, 1, 1, 256, 2, 1, 64,
                                                   16)]
    got = ssd_bwd_tensor_cores(*ts, hs=2, mm=mm1)
    want = ssd_chunk_bwd_ref(*ts)
    assert sum(_violations(g.numpy(), w.numpy(), K3_GATE)
               for g, w in zip(got, want)) > 0


def test_k3_bwd_slices_change_only_the_order_of_sums():
    """One slice per head and one slice per group give the same gradients
    to float32 rounding: the slices are a cut of the same sum."""
    ts = [torch.from_numpy(a) for a in _ssd_inputs(2, 1, 1, 128, 4, 1, 16,
                                                   8)]
    a = ssd_bwd_tensor_cores(*ts, hs=1)
    b = ssd_bwd_tensor_cores(*ts, hs=4)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---- K3-bwd: the wrapper's figures against the source's -------------------

SOURCE = (_nvcc.CSRC / "ssd_chunk_bwd.cu").read_text()


def test_k3_bwd_shared_memory_is_the_source_figure():
    """The source states 216,576 bytes at hp 64, Q 256 (hymba-1.5B and
    mamba2-2.7b alike: ds does not enter) and 355,840 at hp 128."""
    assert "216,576" in SOURCE and "355,840" in SOURCE
    for ds in (16, 128):
        assert sc.bwd_smem_bytes(256, 64, ds) == 216_576
    assert sc.bwd_smem_bytes(256, 128, 16) == 355_840
    assert sc.bwd_smem_bytes(256, 128, 16) > sc.SMEM_LIMIT
    # Each q tile of the chunk holds a 16 KiB dCB^T of the slice.
    assert sc.bwd_smem_bytes(64, 64, 128) == 216_576 - 3 * 16_384


@pytest.mark.parametrize("Q,hp", [(256, 64), (64, 64), (37, 64), (32, 32),
                                  (16, 16), (200, 40), (256, 16)])
def test_k3_bwd_test_and_model_shapes_fit_a_block(Q, hp):
    assert sc.bwd_smem_bytes(Q, hp, 16) <= sc.SMEM_LIMIT


@pytest.mark.parametrize("args,hs", [
    ((4, 8, 256, 50, 1), 17),   # hymba training: 3 slices, 384 blocks
    ((1, 1, 64, 8, 1), 1),      # few blocks: a head a slice
    ((64, 8, 256, 50, 1), 50),  # many batch-chunks: the whole group
    ((2, 1, 37, 8, 2), 1),
])
def test_k3_bwd_heads_per_slice(args, hs):
    assert sc.bwd_heads_per_slice(*args, sms=132) == hs


def test_k3_bwd_scratch_is_the_source_layout():
    """C B^T and each slice's dCB^T per (pair, group): 10 pairs of 64 x 64
    at Q 256; the slices' state-term dB; dcum's q parts per t tile, its t
    part and F."""
    b, nc, Q, nh, G, ds, hs = 4, 8, 256, 50, 1, 16, 17
    pair_tiles = b * nc * G * 10 * 64 * 64
    rows = b * nc * Q
    want = (1 + 3) * pair_tiles + 3 * rows * G * ds + (4 + 2) * rows * nh
    assert sc.bwd_scratch_floats(b, nc, Q, nh, G, ds, hs) == want == 8_093_696


# ---- both sources: wgmma, no CUDA-core products, no atomics ---------------

def test_backward_sources_issue_wgmma_with_no_cuda_core_products():
    header = (_nvcc.CSRC / "sm90_tf32x3.cuh").read_text()
    k2b = (_nvcc.CSRC / "flash_attention_bwd_sm90.cu").read_text()
    assert "m64n64k16.f32.bf16.bf16" in header
    assert '#include "sm90_tf32x3.cuh"' in k2b
    assert "bf16_wgmma_n64_ss(s," in k2b and "bf16_wgmma_n64_ss(dp," in k2b
    for acc in ("acc_v[n]", "acc_k[n]", "acc[n]"):
        assert f"bf16_wgmma_n64_rs({acc}," in k2b
    assert '#include "sm90_tf32x3.cuh"' in SOURCE
    for call in ("tf32x3_ss<64>(s,", "tf32x3_ss<32>(s,", "tf32x3_ss<32>(gacc,",
                 "tf32x3_rs<HPP>(acc, mh", "tf32x3_rs<HPP>(acc, wh",
                 "tf32x3_rs<DSP>(acc,"):
        assert call in SOURCE, call
    fma_sum = re.compile(r"(acc|total|dp|s)(\[[^]]*\])+[.xyzw]*\s*=\s*fmaf")
    for source in (k2b, SOURCE):
        assert not fma_sum.search(source)
        assert "tile_dot" not in source and "tile_acc" not in source
        assert "atomicAdd" not in source and "atom." not in source
