"""The port's K2 wrapper (``repro_torch.kernels.flash_attention``) against
the JAX package's Pallas flash kernel (interpret mode) and its oracle, on
the CPU.

On CPU tensors the wrapper runs its plain version; the three CUDA kernels
(routes ``sm90``, ``tf32x3`` and ``simt``) are held against that plain
version on the card by ``chip_smoke.py``.  Here: the route rule, and what the wrapper does
around the kernels.  Inputs
are made with numpy from a seed and handed to both packages.  Tolerances
are the reference's own (``tests/test_kernels_flash.py``): 2e-5 in float32,
2e-2 in bfloat16.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models.layers import flash_attention as jax_model_flash
from repro_torch.kernels import flash_attention
from repro_torch.kernels import _nvcc
from repro_torch.kernels.flash_attention import (SOURCE, SOURCE_SM90,
                                                 _aligned16, build,
                                                 build_sm90, reset_counts,
                                                 route)
from repro_torch.kernels.ref import flash_attention_ref

# the module (the package exports the function under the same name)
fa_module = importlib.import_module("repro_torch.kernels.flash_attention")

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(seed, B, Sq, Skv, H, KH, Dk, Dv, dtype):
    """The same q, k, v as JAX arrays and torch tensors."""
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((B, Sq, H, Dk), (B, Skv, KH, Dk), (B, Skv, KH, Dv))]
    return ([jnp.asarray(x).astype(jdt) for x in xs],
            [torch.from_numpy(x).to(tdt) for x in xs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


CASES = {   # B, Sq, Skv, H, KH, Dk, Dv, causal, window, (bq, bk)
    "causal-mha": (1, 128, 128, 4, 4, 64, 64, True, 0, (64, 64)),
    "mqa-ragged-blocks": (1, 96, 96, 4, 1, 128, 128, True, 0, (64, 64)),
    "window": (1, 128, 128, 4, 2, 32, 32, True, 16, (64, 64)),
    "noncausal": (2, 64, 64, 4, 4, 32, 32, False, 0, (32, 64)),
    "gqa-window-ragged": (1, 77, 77, 4, 2, 32, 32, True, 20, (64, 64)),
    "mla-dk96-dv64": (1, 70, 70, 2, 2, 96, 64, True, 0, (64, 64)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_pallas_and_oracle(case, dtype):
    B, Sq, Skv, H, KH, Dk, Dv, causal, window, (bq, bk) = CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _qkv(len(case), B, Sq, Skv, H, KH, Dk, Dv,
                                      dtype)
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == DTYPES[dtype][1]
    assert tuple(out.shape) == (B, Sq, H, Dv)
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    block_q=bq, block_k=bk, interpret=True)
    oracle = jax_flash_ref(jq, jk, jv, causal=causal, window=window)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_f32(out), _f32(pallas), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(out), _f32(oracle), rtol=tol, atol=tol)


def test_flash_matches_model_stack_flash():
    """The port's K2 and the reference model stack's chunked flash agree
    (the reference model never calls its Pallas kernel)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 2, 128, 128, 8, 2, 64, 64,
                                      "float32")
    out = flash_attention(tq, tk, tv, causal=True, window=48)
    ref = jax_model_flash(jq, jk, jv, causal=True, window=48, kv_chunk=64)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=2e-5, atol=2e-5)


def test_flash_scale_and_strided_inputs():
    """An explicit scale, and q/k/v that are strided views (the model hands
    the kernel slices), give the oracle's result."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(5, 1, 40, 40, 4, 2, 32, 32, "float32")
    wide = torch.cat([tq, tq], dim=-1)[..., :32]          # non-contiguous
    assert not wide.is_contiguous()
    out = flash_attention(wide, tk, tv, scale=0.3)
    oracle = jax_flash_ref(jq, jk, jv, scale=0.3)
    np.testing.assert_allclose(_f32(out), _f32(oracle), rtol=2e-5, atol=2e-5)


def test_plain_version_masks_with_a_select():
    """A window of 1 keeps only the diagonal: the output is v itself."""
    _, (tq, tk, tv) = _qkv(7, 1, 16, 16, 2, 2, 8, 8, "float32")
    out = flash_attention_ref(tq, tk, tv, window=1)
    torch.testing.assert_close(out, tv, rtol=0, atol=1e-6)


def test_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="do not group"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="disagree"):
        flash_attention(q, torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 2, 8))
    with pytest.raises(TypeError, match="float32 or"):
        flash_attention(q.half(), q.half(), q.half())
    # the operator's fake implementation serves the meta device: shapes
    # and dtypes only, nothing launched or counted
    meta = torch.empty((1, 8, 4, 16), device="meta")
    before = flash_attention.launches
    out = flash_attention(meta, meta, meta[..., :8])
    assert out.is_meta and out.shape == (1, 8, 4, 8)
    assert flash_attention.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fa_module._forward(meta, meta, meta, True, 0, None, False)


def test_cpu_calls_do_not_count_launches():
    before = flash_attention.launches
    x = torch.ones(1, 8, 2, 16)
    flash_attention(x, x, x)
    flash_attention(x.bfloat16(), x.bfloat16(), x.bfloat16(), window=3)
    assert flash_attention.launches == before


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    """No fallback: without a card no CUDA tensor can reach the wrapper,
    and without a toolkit the kernel cannot be built — both raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        torch.zeros(1, device="cuda")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr("repro_torch.kernels._nvcc.BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        build()


ROUTES = {   # dtype, Dk, Dv -> route
    "f32-64": (torch.float32, 64, 64, "tf32x3"),
    "f32-256": (torch.float32, 256, 256, "tf32x3"),
    "bf16-64": (torch.bfloat16, 64, 64, "sm90"),
    "bf16-mla-96-64": (torch.bfloat16, 96, 64, "sm90"),
    "bf16-160": (torch.bfloat16, 160, 160, "sm90"),
    "bf16-256": (torch.bfloat16, 256, 256, "sm90"),
    "bf16-32": (torch.bfloat16, 32, 32, "sm90"),
    "bf16-40": (torch.bfloat16, 40, 40, "simt"),
    "bf16-64-40": (torch.bfloat16, 64, 40, "simt"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_rule(case):
    """bf16 at head dims that are multiples of 16 up to 256 goes to the
    bf16 tensor-core kernel, float32 (3xTF32, for the 2e-5 gate) to the
    float32 tensor-core kernel at every head dim, and bf16 at any other
    dims to the CUDA-core kernel."""
    dtype, dk, dv, want = ROUTES[case]
    assert route(dtype, dk, dv) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rejects_head_dims_above_256(dtype):
    ok = torch.zeros(1, 8, 2, 256, dtype=dtype)
    wide = torch.zeros(1, 8, 2, 272, dtype=dtype)
    assert flash_attention(ok, ok, ok).shape == (1, 8, 2, 256)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(wide, wide, wide)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(ok, ok, wide)


@pytest.mark.parametrize("case", ["f32-64", "bf16-64", "bf16-mla-96-64",
                                  "bf16-40"])
def test_cpu_calls_count_no_launches_on_either_route(case):
    dtype, dk, dv, _ = ROUTES[case]
    counts = (flash_attention.launches, flash_attention.launches_sm90,
              flash_attention.launches_simt)
    q = torch.ones(1, 8, 2, dk, dtype=dtype)
    out = flash_attention(q, q, torch.ones(1, 8, 2, dv, dtype=dtype))
    assert out.shape == (1, 8, 2, dv)
    assert (flash_attention.launches, flash_attention.launches_sm90,
            flash_attention.launches_simt) == counts


def test_reset_counts_zeroes_all_three():
    flash_attention.launches_sm90 += 2
    flash_attention.launches_simt += 1
    flash_attention.launches += 3
    reset_counts()
    assert (flash_attention.launches, flash_attention.launches_sm90,
            flash_attention.launches_simt) == (0, 0, 0)


def test_aligned16_copies_only_misaligned_rows():
    """The sm90 kernel copies 16-byte rows: a view whose rows start off a
    16-byte boundary is copied (same values), an aligned one is not."""
    base = torch.arange(2 * 8 * 3 * 72, dtype=torch.float32).bfloat16()
    aligned = base.view(2, 8, 3, 72)[..., :64]      # strides multiples of 8
    assert _aligned16(aligned) is aligned
    odd = base[4:4 + 2 * 8 * 3 * 66].view(2, 8, 3, 66)[..., :64]
    fixed = _aligned16(odd)
    assert fixed is not odd and fixed.is_contiguous()
    assert fixed.data_ptr() % 16 == 0
    assert torch.equal(fixed, odd)


class _ReportsCuda:
    """A CPU tensor that reports a CUDA device: it takes the operator's
    implementation down its CUDA branch on a machine with no card."""
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.mark.parametrize("route_name", ["sm90", "simt"])
def test_each_route_raises_without_a_card(route_name, monkeypatch, tmp_path):
    """No fallback on either route: without a card no CUDA tensor exists,
    and without a toolkit the wrapper's CUDA branch raises when it loads
    the kernel of its route, and launches and counts nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        torch.zeros(1, device="cuda", dtype=torch.bfloat16)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr("repro_torch.kernels._nvcc.BUILD_DIR", tmp_path)
    monkeypatch.setattr("repro_torch.kernels._nvcc._libs", {})
    source, builder = {"sm90": (SOURCE_SM90, build_sm90),
                       "simt": (SOURCE, build)}[route_name]
    with pytest.raises(RuntimeError, match="nvcc"):
        builder()
    loaded, load = [], _nvcc.load

    def spy(src, entries):
        loaded.append(src)
        return load(src, entries)

    monkeypatch.setattr(_nvcc, "load", spy)
    cases = [c for c in sorted(ROUTES) if ROUTES[c][3] == route_name]
    assert cases
    for case in cases:
        dtype, dk, dv, _ = ROUTES[case]
        counts = (flash_attention.launches, flash_attention.launches_sm90,
                  flash_attention.launches_simt)
        q = _ReportsCuda(torch.ones(1, 8, 2, dk, dtype=dtype))
        v = _ReportsCuda(torch.ones(1, 8, 2, dv, dtype=dtype))
        loaded.clear()
        with pytest.raises(RuntimeError, match="nvcc"):   # the operator's
            fa_module._forward(q, q, v, True, 0, None, False)  # CUDA branch
        assert loaded == [source], case
        assert (flash_attention.launches, flash_attention.launches_sm90,
                flash_attention.launches_simt) == counts
