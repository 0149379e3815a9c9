"""The port's K3 wrapper (``repro_torch.kernels.ssd_chunk``) against the JAX
package's Pallas SSD kernel (interpret mode) and its oracle, and the port's
``ssd_scan`` against the reference's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the reference's own (``tests/test_kernels_ssd.py``): 1e-4
in float32, 3e-2 in bfloat16, 2e-4 for the composed scan.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_chunk_ref as jax_ssd_ref
from repro.kernels.ssd_chunk import ssd_chunk_pallas
from repro.models.ssm import ssd_scan as jax_ssd_scan
from repro_torch.kernels import ssd_chunk
from repro_torch.kernels.ref import ssd_chunk_ref
from repro_torch.kernels.ssd_chunk import build
from repro_torch.models.ssm import ssd_scan

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _softplus(x):
    return np.logaddexp(x, 0.0)


def _inputs(seed, b, nc, Q, nh, G, hp, ds, dtype="float32"):
    """xdt, B, C (in ``dtype``) and cum (float32), as JAX arrays and torch
    tensors holding the same values."""
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((b, nc, Q, nh, hp)).astype(np.float32) * 0.5
    B = rng.standard_normal((b, nc, Q, G, ds)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, nc, Q, G, ds)).astype(np.float32) * 0.5
    dtA = -_softplus(rng.standard_normal((b, nc, Q, nh))).astype(np.float32)
    cum = np.cumsum(dtA, axis=2).astype(np.float32)
    jdt, tdt, _ = DTYPES[dtype]
    jax_in = [jnp.asarray(x).astype(jdt) for x in (xdt, B, C)]
    torch_in = [torch.from_numpy(x).to(tdt) for x in (xdt, B, C)]
    return ((*jax_in, jnp.asarray(cum)),
            (*torch_in, torch.from_numpy(cum)))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


CASES = {   # b, nc, Q, nh, G, hp, ds, dtype
    "small": (1, 2, 16, 4, 1, 16, 16, "float32"),
    "grouped": (2, 3, 32, 4, 2, 32, 16, "float32"),
    "mamba2-dims": (1, 1, 64, 8, 1, 64, 128, "float32"),
    "ragged-q": (1, 2, 37, 4, 2, 16, 16, "float32"),
    "bf16": (1, 2, 32, 4, 1, 32, 32, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssd_chunk_matches_pallas_and_oracle(case):
    b, nc, Q, nh, G, hp, ds, dtype = CASES[case]
    jin, tin = _inputs(Q + nh, b, nc, Q, nh, G, hp, ds, dtype)
    y, st = ssd_chunk(*tin)
    assert y.dtype == DTYPES[dtype][1] and st.dtype == torch.float32
    assert tuple(y.shape) == (b, nc, Q, nh, hp)
    assert tuple(st.shape) == (b, nc, nh, ds, hp)
    tol = DTYPES[dtype][2]
    for want_y, want_st in (ssd_chunk_pallas(*jin, interpret=True),
                            jax_ssd_ref(*jin)):
        np.testing.assert_allclose(_f32(y), _f32(want_y), rtol=tol, atol=tol)
        np.testing.assert_allclose(_f32(st), _f32(want_st), rtol=tol,
                                   atol=tol)


def test_ssd_chunk_overflowing_decay_gives_no_nan():
    """cum falls steeply, so exp(cum_q - cum_t) overflows to inf wherever
    q < t; the decay is selected away there, never multiplied by 0."""
    _, (xdt, B, C, _) = _inputs(1, 1, 1, 32, 2, 1, 8, 8)
    cum = torch.linspace(0.0, -400.0, 32).view(1, 1, 32, 1).repeat(1, 1, 1, 2)
    assert torch.isinf(torch.exp(cum[0, 0, 0, 0] - cum[0, 0, -1, 0]))
    y, st = ssd_chunk(xdt, B, C, cum)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    y_ref, st_ref = jax_ssd_ref(jnp.asarray(xdt.numpy()),
                                jnp.asarray(B.numpy()), jnp.asarray(C.numpy()),
                                jnp.asarray(cum.numpy()))
    np.testing.assert_allclose(_f32(y), _f32(y_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_f32(st), _f32(st_ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S,chunk,G", [(64, 16, 1), (37, 16, 2), (5, 8, 1)])
def test_ssd_scan_matches_reference(S, chunk, G):
    """K3 + the port's inter-chunk loop == the reference's ssd_scan (which
    computes the intra-chunk part inline), ragged last chunk included."""
    rng = np.random.default_rng(S)
    b, nh, hp, ds = 2, 4, 16, 16
    xh = rng.standard_normal((b, S, nh, hp)).astype(np.float32)
    B = rng.standard_normal((b, S, G, ds)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, S, G, ds)).astype(np.float32) * 0.5
    dt = _softplus(rng.standard_normal((b, S, nh))).astype(np.float32)
    A = -np.exp(np.linspace(-1.0, 0.5, nh)).astype(np.float32)
    y_ref, st_ref = jax_ssd_scan(*(jnp.asarray(x) for x in (xh, B, C, dt, A)),
                                 chunk=chunk)
    before = ssd_chunk.launches
    y, st = ssd_scan(*(torch.from_numpy(x) for x in (xh, B, C, dt, A)),
                     chunk=chunk)
    assert ssd_chunk.launches == before      # CPU tensors: the plain version
    np.testing.assert_allclose(_f32(y), _f32(y_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_f32(st), _f32(st_ref), rtol=2e-4, atol=2e-4)


def test_rejects_bad_inputs():
    _, (xdt, B, C, cum) = _inputs(0, 1, 1, 8, 4, 1, 8, 8)
    with pytest.raises(ValueError, match="do not group"):
        ssd_chunk(xdt, B.repeat(1, 1, 1, 3, 1), C.repeat(1, 1, 1, 3, 1), cum)
    with pytest.raises(ValueError, match="cum"):
        ssd_chunk(xdt, B, C, cum[..., :2])
    with pytest.raises(TypeError, match="cum must be float32"):
        ssd_chunk(xdt, B, C, cum.double())
    with pytest.raises(TypeError, match="float32 or"):
        ssd_chunk(xdt.half(), B.half(), C.half(), cum)
    # the operator's fake implementation serves the meta device
    meta = [x.to("meta") for x in (xdt, B, C, cum)]
    y, st = ssd_chunk(*meta)
    assert y.is_meta and y.shape == xdt.shape and y.dtype == xdt.dtype
    assert st.shape == (1, 1, 4, 8, 8) and st.dtype == torch.float32
    with pytest.raises(ValueError, match="unsupported device"):
        importlib.import_module("repro_torch.kernels.ssd_chunk")._forward(
            *meta)


def test_plain_version_matches_the_oracle_in_bf16_inputs():
    jin, tin = _inputs(3, 1, 1, 16, 2, 1, 8, 8, "bfloat16")
    y, st = ssd_chunk_ref(*tin)
    y_ref, st_ref = jax_ssd_ref(*jin)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(y), _f32(y_ref), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(_f32(st), _f32(st_ref), rtol=1e-4, atol=1e-4)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr("repro_torch.kernels._nvcc.BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        build()
