"""The port's K1 wrapper (``repro_torch.kernels.matmul``) against the JAX
package's Pallas kernel (interpret mode) and its oracle, on the CPU.

On CPU tensors the wrapper runs its plain version; the CUDA kernel itself is
held against that plain version on the card by ``chip_smoke.py``.  Inputs
are made with numpy from a seed and handed to both packages.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul import matmul_pallas
from repro.kernels.ref import matmul_ref as jax_matmul_ref
from repro_torch.core import HGemms, cuda_kernel_runner, paper_mach1
from repro_torch.kernels import matmul
from repro_torch.kernels.matmul import build
from repro_torch.kernels.ref import matmul_ref

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4, 1e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 2e-1)}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor (bf16 rounding is
    round-to-nearest-even in both)."""
    jdt, tdt, _, _ = DTYPES[dtype]
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (100, 130, 50),
                                   (8, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas_and_oracle(m, k, n, dtype):
    rng = np.random.default_rng(m * 7 + n)
    ja, ta = _pair(rng, (m, k), dtype)
    jb, tb = _pair(rng, (k, n), dtype)
    out = matmul(ta, tb)
    assert out.dtype == DTYPES[dtype][1]
    assert tuple(out.shape) == (m, n)
    pallas = matmul_pallas(ja, jb, block_m=64, block_n=128, block_k=128,
                           interpret=True)
    oracle = jax_matmul_ref(ja, jb)
    _, _, rtol, atol = DTYPES[dtype]
    np.testing.assert_allclose(_f32(out), _f32(pallas), rtol=rtol, atol=atol)
    np.testing.assert_allclose(_f32(out), _f32(oracle), rtol=rtol, atol=atol)


def test_matmul_f32_accumulation_in_bf16():
    """bf16 inputs accumulate in f32, as the Pallas kernel does."""
    k = 4096
    a = torch.full((8, k), 0.01, dtype=torch.bfloat16)
    b = torch.full((k, 128), 0.01, dtype=torch.bfloat16)
    out = matmul(a, b)
    pallas = matmul_pallas(jnp.full((8, k), 0.01, jnp.bfloat16),
                           jnp.full((k, 128), 0.01, jnp.bfloat16),
                           interpret=True)
    expected = k * 0.01 * 0.01
    rel = abs(float(out[0, 0]) - expected) / expected
    assert rel < 0.02, rel
    np.testing.assert_allclose(_f32(out), _f32(pallas), rtol=2e-2, atol=2e-1)


def test_mixed_inputs_promote_like_jax():
    rng = np.random.default_rng(1)
    ja, ta = _pair(rng, (16, 32), "float32")
    jb, tb = _pair(rng, (32, 24), "bfloat16")
    out = matmul(ta, tb)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_f32(out), _f32(jax_matmul_ref(ja, jb)),
                               rtol=1e-4, atol=1e-3)


def test_row_slice_is_taken_in_place():
    """A block of a larger C-contiguous matrix (HGemms partitions A by
    rows) is read through its leading dimension, without a copy; a
    transposed view is refused rather than copied silently."""
    rng = np.random.default_rng(2)
    full = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    rows = full[10:30, :40]
    assert rows.stride() == (48, 1)
    np.testing.assert_allclose(matmul(rows, b).numpy(),
                               rows.numpy() @ b.numpy(), rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="unit column stride"):
        matmul(full.t()[:, :64], torch.zeros(64, 4))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16,
                                   torch.int32])
def test_rejects_types_the_kernel_does_not_take(dtype):
    a = torch.zeros((4, 4), dtype=dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        matmul(a, a)


def test_rejects_bad_shapes_and_devices():
    with pytest.raises(ValueError, match="do not chain"):
        matmul(torch.zeros(4, 5), torch.zeros(4, 5))
    with pytest.raises(ValueError, match="do not chain"):
        matmul(torch.zeros(4), torch.zeros(4, 5))
    # the operator's fake implementation serves the meta device
    meta = torch.empty((4, 4), device="meta")
    out = matmul(meta, meta[:, :3])
    assert out.is_meta and out.shape == (4, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        importlib.import_module("repro_torch.kernels.matmul")._launch(
            meta, meta)


def test_plain_version_is_torch_matmul_in_f32():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((20, 30)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((30, 10)).astype(np.float32))
    torch.testing.assert_close(matmul_ref(a, b), a @ b)
    assert matmul_ref(a.bfloat16(), b.bfloat16()).dtype == torch.bfloat16


def test_cpu_calls_do_not_count_launches():
    before = matmul.launches
    matmul(torch.ones(8, 8), torch.ones(8, 8))
    matmul(torch.ones(8, 8, dtype=torch.bfloat16),
           torch.ones(8, 8, dtype=torch.bfloat16))
    assert matmul.launches == before


def test_cuda_without_a_card_raises():
    """No fallback: asking for the card where there is none is an error."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_kernel_runner("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        HGemms(paper_mach1(), device="cuda")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build()
