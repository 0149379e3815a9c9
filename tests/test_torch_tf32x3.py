"""3xTF32, the arithmetic of the port's tensor-core K1 (float32) and K3, on
the CPU: a torch emulation of ``cvt.rna.tf32.f32`` and of the hi/lo split
as the kernels do it and the tensor cores read it,
the accuracy it buys against the reference's float32 gates, the register
and shared-memory index maps K3 relies on, and the wrapper rules around
both kernels.

The CUDA kernels themselves are held against their plain versions on the
card by ``chip_smoke.py``.  Inputs are made with numpy from a seed; the
K3 emulation is held against both packages' ``ssd_chunk_ref``.
"""
import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_chunk_ref as jax_ssd_ref
from repro_torch.kernels import _nvcc, matmul, ssd_chunk
from repro_torch.kernels.ref import ssd_chunk_ref

# The package exports the wrappers under their modules' names.
matmul_mod = importlib.import_module("repro_torch.kernels.matmul")
ssd_mod = importlib.import_module("repro_torch.kernels.ssd_chunk")

F32_GATE = (1e-4, 1e-3)   # rtol, atol: tests/test_kernels_matmul.py:34
K3_GATE = 1e-4            # tests/test_kernels_ssd.py:34
PANEL = 256               # K1's accumulator panel (csrc/matmul.cu)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: the nearest value with 10 mantissa bits, ties
    away from zero (add half a tf32 ulp to the magnitude's bits, then drop
    the 13 low bits)."""
    bits = x.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = ((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """An f32 value as a tf32 operand reads it: its top 19 bits."""
    return (x.float().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """hi = tf32(x) rounded to nearest (``split_tf32`` in
    csrc/sm90_tf32x3.cuh, the rounding of ``cvt.rna.tf32.f32``), lo = x - hi
    (exact in f32) as the tensor cores read it."""
    hi = tf32_rna(x)
    return hi, tf32_trunc(x.float() - hi)


def tf32x3(a_hi, a_lo, b_hi, b_lo) -> torch.Tensor:
    """The three tensor-core products, small terms first, each an exact
    product of tf32 values summed in float32."""
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _violations(got, want, rtol, atol) -> int:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return int((np.abs(got - want) > atol + rtol * np.abs(want)).sum())


# ---- the split ---------------------------------------------------------

@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),         # a tie rounds away from zero
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 2.0**-12, 1.0),                    # below the tie: down
    (1.0 + 3 * 2.0**-12, 1.0 + 2.0**-10),     # above the tie: up
    (0.0, 0.0),
    (float("inf"), float("inf")),
])
def test_tf32_rna_rounds_to_nearest_ties_away(x, want):
    assert float(tf32_rna(torch.tensor([x]))[0]) == want


def test_split_keeps_float32_accuracy():
    """hi has 10 mantissa bits; hi + lo is within 2^-21 of x (f32 keeps
    2^-24); hi alone is only within 2^-11."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(100_000)
                         .astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    rel_hi = ((x.double() - hi.double()).abs() / x.double().abs()).max()
    rel_3 = ((x.double() - hi.double() - lo.double()).abs()
             / x.double().abs()).max()
    assert float(rel_hi) <= 2.0**-11
    assert float(rel_3) <= 2.0**-21


def test_three_terms_meet_the_f32_gate_where_one_term_fails():
    """At K = 4096, against float64: one TF32 product breaks rtol 1e-4 /
    atol 1e-3, the three-term split meets it."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 4096)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((4096, 64)).astype(np.float32))
    exact = (a.double() @ b.double()).numpy()
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    one = (a_hi @ b_hi).numpy()
    three = tf32x3(a_hi, a_lo, b_hi, b_lo).numpy()
    assert _violations(one, exact, *F32_GATE) > 0
    assert _violations(three, exact, *F32_GATE) == 0
    assert np.abs(three - exact).max() < np.abs(one - exact).max() / 100


def test_panelled_three_terms_meet_the_gate_at_i1_depth():
    """K1's f32 path at the i1 depth K = 30000: 3xTF32 per 256-deep panel,
    panels added into a running float32 total, within the unscaled gate of
    float64."""
    rng = np.random.default_rng(2)
    k = 30_000
    a = torch.from_numpy(rng.standard_normal((16, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 16)).astype(np.float32))
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    total = torch.zeros((16, 16))
    for k0 in range(0, k, PANEL):
        s = slice(k0, k0 + PANEL)
        total += tf32x3(a_hi[:, s], a_lo[:, s], b_hi[s], b_lo[s])
    exact = (a.double() @ b.double()).numpy()
    assert _violations(total.numpy(), exact, *F32_GATE) == 0


# ---- K3's algorithm ------------------------------------------------------

def _ssd_inputs(seed, b, nc, Q, nh, G, hp, ds):
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((b, nc, Q, nh, hp)).astype(np.float32) * 0.5
    B = rng.standard_normal((b, nc, Q, G, ds)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, nc, Q, G, ds)).astype(np.float32) * 0.5
    dtA = -np.logaddexp(rng.standard_normal((b, nc, Q, nh)), 0.0)
    cum = np.cumsum(dtA.astype(np.float32), axis=2).astype(np.float32)
    return xdt, B, C, cum


def ssd_chunk_tf32x3(xdt, B, C, cum, tile=64):
    """K3 as the kernel computes it: per 64-row q tile, the t tiles up to
    the diagonal; CB = C·Bᵀ in 3xTF32; P = CB∘L selected; P split again and
    multiplied by the split xdt in 3xTF32.  The state is the same product
    for query rows C = I at cum_end with no mask: P = (B_hi + B_lo)·w."""
    b, nc, Q, nh, hp = xdt.shape
    hg = nh // B.shape[3]
    y = torch.zeros((b, nc, Q, nh, hp))
    x = torch.from_numpy(xdt)
    Bh = torch.from_numpy(B).repeat_interleave(hg, dim=3)
    Ch = torch.from_numpy(C).repeat_interleave(hg, dim=3)
    cm = torch.from_numpy(cum)
    x_hi, x_lo = split(x.permute(0, 1, 3, 2, 4))          # (b,nc,nh,Q,hp)
    b_hi, b_lo = split(Bh)                                 # (b,nc,Q,nh,ds)
    for q0 in range(0, Q, tile):
        q = slice(q0, min(q0 + tile, Q))
        c_hi, c_lo = split(Ch[:, :, q])                   # (b,nc,tq,nh,ds)
        acc = torch.zeros((b, nc, nh, q.stop - q0, hp))
        for t0 in range(0, q.stop, tile):
            t = slice(t0, min(t0 + tile, Q))
            cb = tf32x3(*(v.permute(0, 1, 3, 2, 4) for v in (c_hi, c_lo)),
                        *(v[:, :, t].permute(0, 1, 3, 4, 2)
                          for v in (b_hi, b_lo)))
            qi = torch.arange(q0, q.stop)[:, None]
            ti = torch.arange(t0, t.stop)[None, :]
            cq = cm[:, :, q].permute(0, 1, 3, 2)[..., :, None]
            ct = cm[:, :, t].permute(0, 1, 3, 2)[..., None, :]
            p = torch.where(ti <= qi, cb * torch.exp(cq - ct),
                            torch.zeros(()))
            p_hi, p_lo = split(p)
            acc += tf32x3(p_hi, p_lo, x_hi[..., t, :], x_lo[..., t, :])
        y[:, :, q] = acc.permute(0, 1, 3, 2, 4)
    w = torch.exp(cm[:, :, -1:, :] - cm)                   # (b,nc,Q,nh)
    bw = ((b_hi + b_lo) * w[..., None]).permute(0, 1, 3, 4, 2)
    p_hi, p_lo = split(bw)                                 # (b,nc,nh,ds,Q)
    states = tf32x3(p_hi, p_lo, x_hi, x_lo)
    return y, states


@pytest.mark.parametrize("shape", [
    (1, 2, 256, 4, 1, 64, 16),      # hymba-1.5B's chunk: Q 256, hp 64, ds 16
    (2, 1, 100, 4, 2, 37, 20),      # ragged Q, grouped, hp/ds off the grid
])
def test_k3_tf32x3_meets_the_f32_gate(shape):
    xdt, B, C, cum = _ssd_inputs(3, *shape)
    y, states = ssd_chunk_tf32x3(xdt, B, C, cum)
    y_ref, st_ref = ssd_chunk_ref(*(torch.from_numpy(v)
                                    for v in (xdt, B, C, cum)))
    y_jax, st_jax = jax_ssd_ref(*(jnp.asarray(v) for v in (xdt, B, C, cum)))
    refs = {"y": (y, y_ref, y_jax), "states": (states, st_ref, st_jax)}
    for name, (got, torch_ref, jax_ref) in refs.items():
        for want in (torch_ref, jax_ref):
            n = _violations(got.numpy(), np.asarray(want), K3_GATE, K3_GATE)
            assert n == 0, _k3_report(name, (xdt, B, C, cum), got,
                                      torch_ref, jax_ref)


def _k3_report(name, inputs, got, torch_ref, jax_ref, most=20) -> str:
    """Where the emulation left the band: each violating index (against
    either reference) with the emulation's value, both packages' plain
    versions, the torch plain version computed again and the float64 one,
    and the process state that torch's CPU kernels read.  A rerun that is
    not bit-equal, or a float64 value beside the emulation's, says that
    the reference moved, not the emulation."""
    pick = {"y": 0, "states": 1}[name]
    args = [torch.from_numpy(v) for v in inputs]
    again = ssd_chunk_ref(*args)[pick].numpy()
    exact = ssd_chunk_ref(*(a.double() for a in args))[pick].numpy()
    g = got.numpy().astype(np.float64)
    cols = [np.asarray(r, np.float64) for r in (torch_ref, jax_ref)]
    bad = np.zeros(g.shape, bool)
    for want in cols:
        bad |= np.abs(g - want) > K3_GATE + K3_GATE * np.abs(want)
    idx = np.argwhere(bad)
    lines = [f"{name}: {len(idx)} elements out of the {K3_GATE} band; "
             f"torch rerun bit-equal={np.array_equal(again, torch_ref)}; "
             f"threads {torch.get_num_threads()}, float32 matmul precision "
             f"{torch.get_float32_matmul_precision()!r}, default dtype "
             f"{torch.get_default_dtype()}"]
    for i in (tuple(int(v) for v in row) for row in idx[:most]):
        got_i, tr, jr, tr2, x64 = (float(a[i]) for a in
                                   (g, *cols, again, exact))
        lines.append(f"  {i}: got {got_i!r} torch {tr!r} jax {jr!r} torch "
                     f"again {tr2!r} float64 {x64!r}")
    return "\n".join(lines)


def test_k3_one_tf32_pass_misses_the_gate():
    """Why K3 splits both products: one TF32 pass of the same algorithm
    misses 1e-4 at hymba's shape."""
    xdt, B, C, cum = _ssd_inputs(4, 1, 1, 256, 2, 1, 64, 16)
    Bh, Ch, x, cm = (torch.from_numpy(v) for v in (B, C, xdt, cum))
    cb = torch.einsum("bnqhs,bnths->bnhqt", tf32_rna(Ch), tf32_rna(Bh))
    ct = cm.transpose(2, 3)
    keep = torch.tril(torch.ones((256, 256), dtype=torch.bool))
    p = torch.where(keep, cb * torch.exp(ct[..., :, None] - ct[..., None, :]),
                    torch.zeros(()))
    y = torch.einsum("bnhqt,bnthp->bnqhp", tf32_rna(p), tf32_rna(x))
    y_ref, _ = ssd_chunk_ref(*(torch.from_numpy(v)
                               for v in (xdt, B, C, cum)))
    assert _violations(y.numpy(), y_ref.numpy(), K3_GATE, K3_GATE) > 0


def _acc_coord(lane, warp, reg):
    """(row, column) of accumulator register ``reg`` of an m64nN f32 wgmma."""
    i, e = divmod(reg, 4)
    return 16 * warp + lane // 4 + 8 * (e >> 1), 8 * i + 2 * (lane % 4) + (e & 1)


def _a_frag_coord(lane, warp, x):
    """(row, logical k) of tf32 A-fragment register ``x`` in a k8 step."""
    return 16 * warp + lane // 4 + 8 * (x & 1), lane % 4 + 4 * (x >> 1)


def test_k3_register_permutation_matches_the_xdt_split():
    """The kernel feeds accumulator registers s[4kk + (0, 2, 1, 3)] of the
    scores as A-fragment registers 0..3 of k step kk, and the split pass
    writes logical k c of each 8-group from t = 2c (c < 4) or 2(c - 4) + 1
    (csrc/ssd_chunk.cu, split_x).  Then sum_k A[row, k] X[k, p] is P @ X."""
    rng = np.random.default_rng(5)
    P = rng.standard_normal((64, 64))
    X = rng.standard_normal((64, 16))
    # xdt's split tile: chunk cc of row p holds t = 8(cc//2) + 2j + cc%2.
    Xk = np.zeros((64, 16))
    for cc in range(16):
        for j in range(4):
            Xk[4 * cc + j] = X[8 * (cc // 2) + 2 * j + cc % 2]
    got = np.zeros((64, 16))
    for warp in range(4):
        for lane in range(32):
            for kk in range(8):
                for x in range(4):
                    e = (x & 1) * 2 + (x >> 1)
                    row, col = _acc_coord(lane, warp, 4 * kk + e)
                    arow, k = _a_frag_coord(lane, warp, x)
                    assert arow == row
                    got[row] += P[row, col] * Xk[8 * kk + k]
    np.testing.assert_allclose(got, P @ X, rtol=1e-12, atol=1e-12)


# ---- wrapper rules ---------------------------------------------------------

def test_aligned_rows_keeps_aligned_tensors():
    x = torch.zeros((8, 64))
    assert _nvcc.aligned_rows(x) is x
    view = torch.zeros((64, 48))[10:30, :40]      # rows 192 bytes apart
    assert _nvcc.aligned_rows(view) is view
    # A size-1 dim is never walked, so its stride (3 here) does not matter.
    one = torch.zeros(64).as_strided((1, 3, 8), (3, 8, 1))
    assert _nvcc.aligned_rows(one) is one


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aligned_rows_pads_rows_that_do_not_start_on_16_bytes(dtype):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((5, 3, 7)).astype(np.float32)
                         ).to(dtype)
    out = _nvcc.aligned_rows(x)
    step = 16 // x.element_size()
    assert out is not x and out.shape == x.shape and out.dtype == dtype
    assert all(st % step == 0 for st in out.stride()[:-1])
    assert out.stride(-1) == 1 and out.data_ptr() % 16 == 0
    assert torch.equal(out, x)


def test_aligned_rows_copies_a_misaligned_base():
    x = torch.zeros(65)[1:].view(8, 8)            # base 4 bytes past 16
    out = _nvcc.aligned_rows(x)
    assert out.data_ptr() % 16 == 0 and torch.equal(out, x)


def test_k1_grid_limit():
    assert matmul_mod.grid_blocks(28_309, 30_000) == 222 * 235
    assert matmul_mod.grid_blocks(1, 1) == 1
    rows = matmul_mod.MAX_BLOCKS * matmul_mod.TILE_M
    assert matmul_mod.grid_blocks(rows, 1) == matmul_mod.MAX_BLOCKS
    with pytest.raises(ValueError, match="grid"):
        matmul_mod.grid_blocks(rows + 1, 1)
    with pytest.raises(ValueError, match="grid"):
        matmul_mod.grid_blocks(2**20, 2**26)


@pytest.mark.parametrize("hp,ds,nbytes", [
    (64, 16, 83_200),           # hymba-1.5B: two blocks an SM
    (64, 128, 230_656),         # mamba2-2.7b
    (128, 128, 197_888),        # the largest dims: one item a block
    (16, 16, 58_624),
])
def test_k3_shared_memory(hp, ds, nbytes):
    assert ssd_mod.smem_bytes(hp, ds) == nbytes


@pytest.mark.parametrize("Q,hp,ds,blocks", [
    (256, 64, 16, 3),     # hymba: q tiles (3, 0), (2, 1); the state
    (256, 64, 128, 3),    # mamba2: the state's two 64-row tiles together
    (37, 64, 16, 2),      # one q tile; the state
    (300, 64, 16, 4),     # five q tiles: (4, 0), (3, 1), (2); the state
    (256, 128, 128, 6),   # one item a block: four q tiles, two state tiles
])
def test_k3_blocks_per_head(Q, hp, ds, blocks):
    assert ssd_mod.blocks_per_head(Q, hp, ds) == blocks


def test_k3_every_dim_up_to_max_fits_a_block():
    for hp in range(1, ssd_mod.MAX_DIM + 1, 3):
        for ds in range(1, ssd_mod.MAX_DIM + 1, 5):
            assert ssd_mod.smem_bytes(hp, ds) <= ssd_mod.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_k3_rejects_types(dtype):
    xdt, B, C, cum = (torch.from_numpy(v) for v in
                      _ssd_inputs(7, 1, 1, 8, 2, 1, 4, 4))
    with pytest.raises(TypeError, match="float32 or"):
        ssd_chunk(xdt.to(dtype), B.to(dtype), C.to(dtype), cum)


def test_k1_rejects_float16_and_k3_rejects_bf16_cum():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        matmul(torch.zeros((4, 4), dtype=torch.float16),
               torch.zeros((4, 4), dtype=torch.float16))
    xdt, B, C, cum = (torch.from_numpy(v) for v in
                      _ssd_inputs(8, 1, 1, 8, 2, 1, 4, 4))
    with pytest.raises(TypeError, match="cum must be float32"):
        ssd_chunk(xdt, B, C, cum.bfloat16())


def test_cpu_calls_count_no_launch():
    xdt, B, C, cum = (torch.from_numpy(v) for v in
                      _ssd_inputs(9, 1, 2, 16, 2, 1, 8, 8))
    m0, s0 = matmul.launches, ssd_chunk.launches
    matmul(torch.ones(3, 5), torch.ones(5, 7))
    ssd_chunk(xdt, B, C, cum)
    ssd_chunk(xdt.bfloat16(), B.bfloat16(), C.bfloat16(), cum)
    assert (matmul.launches, ssd_chunk.launches) == (m0, s0)


def test_header_is_part_of_every_kernel_hash(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _nvcc.source_digest(src)
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _nvcc.source_digest(src) != first


def test_sources_issue_tf32_and_bf16_wgmma_with_no_cuda_core_products():
    """K1's f32 and bf16 entries and K3's products are wgmma in the source:
    3xTF32 (a round-to-nearest tf32 split, three m64nNk8 tf32 products)
    and bf16 m64n128k16; no FMA loop computes C, y or the state."""
    header = (_nvcc.CSRC / "sm90_tf32x3.cuh").read_text()
    k1 = (_nvcc.CSRC / "matmul.cu").read_text()
    k3 = (_nvcc.CSRC / "ssd_chunk.cu").read_text()
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in header
    assert "k8.f32.tf32.tf32" in header
    assert "m64n128k16.f32.bf16.bf16" in header
    assert '#include "sm90_tf32x3.cuh"' in k1 and '#include "sm90_tf32x3.cuh"' in k3
    assert "tf32x3_rs<BN>" in k1 and "bf16_wgmma_n128" in k1
    assert "fmaf" not in k1
    assert "tf32x3_ss<64>" in k3 and "tf32x3_rs<HPP>" in k3
    assert "no TF32 tensor-core path" not in k1
    # No FMA accumulates a product on the CUDA cores in either kernel.
    fma_sum = re.compile(r"(acc|total)(\[[^]]*\])+[.xyzw]*\s*=\s*fmaf")
    assert fma_sum.search("acc[0][jj].x = fmaf(b, x, acc[0][jj].x);")
    for source in (k1, k3):
        assert not fma_sum.search(source)
