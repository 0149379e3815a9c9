"""A decode step past the end of the cache, port against reference (CPU).

The reference writes the new token's cache entry with
``jax.lax.dynamic_update_slice_in_dim``, which clamps the start: a step at
``pos >= S`` overwrites the last slot, and attention then runs over the
whole cache.  The port must do the same (it writes at ``min(pos, S - 1)``)
rather than raise.  One GQA layer (hymba-1.5B's tiny config) and one MLA
layer (minicpm3-4b's) run a single decode step at ``pos == S`` and
``pos == S + 3`` from the same weights (``params_from_reference``) and the
same random cache; output and every cache entry are held at 1e-4, the
tolerance of ``tests/test_torch_models.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as ref_tiny_config
from repro.models import Model as RefModel
from repro.models.layers import attention_decode, mla_decode
from repro_torch.configs import get_tiny_config
from repro_torch.models.convert import params_from_reference

B, S = 2, 8
TOL = 1e-4


def _layer0(arch):
    """The reference's layer-0 attention params and the port's layer-0
    attention module holding the same values."""
    cfg = ref_tiny_config(arch)
    params = jax.tree_util.tree_map(np.asarray,
                                    RefModel(cfg).init(jax.random.PRNGKey(0)))
    port = params_from_reference(get_tiny_config(arch), params, device="cpu")
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                               params["layers"]["attn"])
    return cfg, p, port.layers[0].attn


def _close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=what)


@pytest.mark.parametrize("past", [0, 3])
@pytest.mark.parametrize("window", [0, 4])
def test_gqa_decode_past_the_cache_matches_reference(past, window):
    cfg, p, attn = _layer0("hymba-1_5b")
    rng = np.random.default_rng(10 + past + window)
    x = (rng.standard_normal((B, 1, cfg.d_model)) * 0.5).astype(np.float32)
    kv = {name: rng.standard_normal((B, S, cfg.num_kv_heads, cfg.head_dim)
                                    ).astype(np.float32) for name in "kv"}
    pos = S + past
    want, want_cache = attention_decode(
        p, jnp.asarray(x), {**{n: jnp.asarray(a) for n, a in kv.items()},
                            "pos": jnp.int32(pos)}, cfg, window=window)
    cache = {n: torch.from_numpy(a.copy()) for n, a in kv.items()}
    with torch.inference_mode():
        got = attn.decode(torch.from_numpy(x), cache, pos, window=window)
    _close(got, want, f"output at pos {pos}")
    for name in "kv":
        _close(cache[name], want_cache[name], f"cache {name} at pos {pos}")
    # the clamped write lands in the last slot; the rest is untouched
    np.testing.assert_array_equal(cache["k"][:, :S - 1].numpy(),
                                  kv["k"][:, :S - 1])
    assert not np.array_equal(cache["k"][:, S - 1].numpy(), kv["k"][:, S - 1])


@pytest.mark.parametrize("past", [0, 3])
def test_mla_decode_past_the_cache_matches_reference(past):
    cfg, p, attn = _layer0("minicpm3-4b")
    rng = np.random.default_rng(20 + past)
    x = (rng.standard_normal((B, 1, cfg.d_model)) * 0.5).astype(np.float32)
    lat = {"ckv": rng.standard_normal((B, S, cfg.kv_lora_rank)),
           "krope": rng.standard_normal((B, S, cfg.qk_rope_head_dim))}
    lat = {n: a.astype(np.float32) for n, a in lat.items()}
    pos = S + past
    want, want_cache = mla_decode(
        p, jnp.asarray(x), {**{n: jnp.asarray(a) for n, a in lat.items()},
                            "pos": jnp.int32(pos)}, cfg)
    cache = {n: torch.from_numpy(a.copy()) for n, a in lat.items()}
    with torch.inference_mode():
        got = attn.decode(torch.from_numpy(x), cache, pos)
    _close(got, want, f"output at pos {pos}")
    for name in lat:
        _close(cache[name], want_cache[name], f"cache {name} at pos {pos}")
    np.testing.assert_array_equal(cache["ckv"][:, :S - 1].numpy(),
                                  lat["ckv"][:, :S - 1])
