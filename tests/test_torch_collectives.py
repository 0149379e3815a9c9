"""The port's compressed collectives (``repro_torch.distributed.
collectives``) against the reference's, on the CPU.

``quantize_int8`` draws its rounding uniforms from a ``torch.Generator``;
given the reference's own draws (``jax.random.uniform(key, shape)``, passed
as ``u``) it must give the reference's int8 values and scale byte for byte.
``compressed_psum_mean`` runs on 4 gloo ranks over a ("pod",) mesh and is
held against the reference's ``shard_map`` on 4 forced host devices (a
subprocess), each rank its row, every device the same key (so the same
uniforms).  Tolerances: "none" rtol 1e-6 / atol 1e-9 (four f32 values
added in another order); "bf16": each side adds the four bf16 values in
its own order, three roundings of at most half a bf16 step (2**-8 of the
magnitude, itself at most sum_r |x_r|) each, so the two means differ by at
most 6 · 2**-8 · sum_r |x_r| / 4 per element; "int8" rtol 1e-6 / atol
1e-9 (the same int8 values; their f32 products q·scale add in another
order).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from repro.distributed import collectives as ref_coll
from repro_torch.distributed.collectives import (dequantize_int8,
                                                 quantize_int8)

ROOT = Path(__file__).resolve().parents[1]
TOL = {"none": (1e-6, 1e-9), "int8": (1e-6, 1e-9)}


@pytest.mark.parametrize("shape,scale,seed", [
    ((1024,), 0.01, 0), ((4096,), 3.0, 1), ((64, 33), 1e-4, 2),
    ((7,), 1.0, 3), ((4096,), 0.3e-2, 4)])
def test_quantize_matches_reference_given_its_uniforms(shape, scale, seed):
    x = (np.random.default_rng(seed).standard_normal(shape)
         * scale).astype(np.float32)
    if seed == 4:
        x = np.full(shape, 0.3e-2, np.float32)     # the unbiasedness input
    key = jax.random.PRNGKey(seed)
    q_ref, s_ref = ref_coll.quantize_int8(jnp.asarray(x), key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, shape)))
    q, s = quantize_int8(torch.from_numpy(x), u=u)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.asarray(q_ref).tobytes() == q.numpy().tobytes()
    assert np.asarray(s_ref, np.float32).tobytes() == s.numpy().tobytes()
    back = dequantize_int8(q, s, torch.float32)
    want = ref_coll.dequantize_int8(q_ref, s_ref, jnp.float32)
    assert np.asarray(want).tobytes() == back.numpy().tobytes()


def test_int8_quantization_error_bounded():
    """``tests/test_distributed.py``'s bound: at most one step."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1024).astype(np.float32)) * 0.01
    q, scale = quantize_int8(x, torch.Generator().manual_seed(1))
    x2 = dequantize_int8(q, scale, torch.float32)
    assert float((x2 - x).abs().max()) <= float(scale) * 1.01


def test_int8_stochastic_rounding_unbiased():
    """``tests/test_distributed.py``'s: zero mean over 20 generators."""
    x = torch.full((4096,), 0.3e-2)
    errs = []
    for i in range(20):
        q, s = quantize_int8(x, torch.Generator().manual_seed(i))
        errs.append(float((dequantize_int8(q, s, torch.float32) - x).mean()))
    assert abs(np.mean(errs)) < 5e-6


def test_quantize_draws_from_its_generator():
    x = torch.linspace(-1, 1, 999)
    a = quantize_int8(x, torch.Generator().manual_seed(7))[0]
    b = quantize_int8(x, torch.Generator().manual_seed(7))[0]
    c = quantize_int8(x, torch.Generator().manual_seed(8))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("psum")
    ref = tmp / "psum.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "_jax_mesh_ref.py"), "psum",
                        str(ref)], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    _torch_dist.spawn(_torch_dist.psum_ranks, 4, tmp, str(ref), str(tmp))
    return dict(np.load(ref)), _torch_dist.load(tmp, "psum", 4)


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
@pytest.mark.parametrize("label", ["seeded", "example"])
def test_compressed_psum_mean_matches_shard_map(ranks, label, mode):
    ref, results = ranks
    want = ref[f"out/{label}/{mode}"]
    x = ref[f"x/{label}"]
    for res in results:
        r = res["coord"]
        got = res[f"{label}/{mode}"].numpy()
        if mode == "bf16":
            bound = 6 * 2.0 ** -8 * np.abs(x).sum(0) / len(x)
            assert (np.abs(got - want[r]) <= bound).all(), f"rank {r}"
        else:
            rtol, atol = TOL[mode]
            np.testing.assert_allclose(got, want[r], rtol=rtol, atol=atol,
                                       err_msg=f"rank {r}")
    if mode == "none":
        np.testing.assert_allclose(want[0], ref[f"x/{label}"].mean(0),
                                   rtol=1e-6, atol=1e-9)


def test_compressed_psum_mean_from_generators(ranks):
    """int8 with each rank's own generator: within one step of each
    rank's scale (summed, over n) of the exact mean."""
    ref, results = ranks
    x = ref["x/seeded"]
    steps = np.abs(x).max(axis=1).sum() / 127.0 / len(x)
    for res in results:
        err = np.abs(res["generator/int8"].numpy() - x.mean(0)).max()
        assert err <= steps * 1.01, err


def test_tree_compressed_psum_mean(ranks):
    ref, results = ranks
    x = ref["x/seeded"].mean(0)
    for res in results:
        tree = res["tree"]
        assert list(tree) == ["a", "b"]
        np.testing.assert_allclose(tree["b"].numpy(), x, rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(tree["a"]["c"].numpy(), 2 * x, rtol=1e-6,
                                   atol=1e-9)
