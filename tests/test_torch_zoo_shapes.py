"""Six configurations at their own head and state shapes: the port's model
stack against the reference (``repro.models.Model``) on the CPU, float32.

``tests/test_torch_models.py`` holds every architecture at ``reduced()``
widths (head dim 16, state 16, chunk 8), so the shapes these configurations
run on the card never meet the reference there: stablelm-12b's 32/8 heads
of 160, musicgen-medium's 24/24 heads of 64 (MHA, audio stub), internvl2-26b's
48/8 of 128 (vision stub), qwen2-72b's 64/8 of 128 with QKV bias,
deepseek-67b's 64/8 of 128, and mamba2-2.7B's 80 SSM heads of 64 at state
128 and chunk 256.  Each case keeps those shapes (heads, KV heads, head dim;
SSM heads, head dim, state, chunk; ``qkv_bias``; the frontend) and cuts
depth to 2, vocab and d_ff to 512, and d_model to ``D_MODEL`` where no kept
shape follows from it (mamba2 keeps 2560: its 80 heads are d_inner / 64).

Weights are the reference's ``Model.init(PRNGKey(0))`` loaded through
``params_from_reference(..., device="cpu")``; tokens and stub embeddings
are made with numpy from a seed.  Held at ``test_torch_models.TOL``: the
prefill's logits, three decode steps' logits, the loss and every
gradient's relative norm.  mamba2's prompt (1 x 300) spans a whole chunk
of 256 and a ragged one.  Its gradients are taken on both sides at chunk
``SSM_GRAD_CHUNK`` (2): the reference's gradient is NaN at 256 (ROADMAP
C3: select-after-exp), and at this width at chunks 8 and 4 too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.convert import params_from_reference
from test_torch_models import TOL

ZOO = ("mamba2-2_7b", "stablelm-12b", "musicgen-medium", "internvl2-26b",
       "qwen2-72b", "deepseek-67b")
D_MODEL = 256
DECODE_STEPS = 3
SSM_GRAD_CHUNK = 2


def _cut(cfg, **overrides):
    """``cfg`` at depth 2, vocab and d_ff 512, d_model ``D_MODEL`` unless
    its SSM heads follow from it; every head and state shape kept."""
    small = dict(num_layers=2, vocab_size=512, dtype="float32",
                 remat="none")
    if cfg.d_ff:
        small["d_ff"] = 512
    if not cfg.uses_ssm:
        small["d_model"] = D_MODEL
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


def _pair(arch, **overrides):
    cfg = _cut(ref_config(arch), **overrides)
    ref = RefModel(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = params_from_reference(_cut(get_config(arch), **overrides),
                                 jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    return cfg, ref, params, port


def _close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=what)


def test_the_cuts_keep_the_published_shapes():
    for arch in ZOO:
        full, cut = get_config(arch), _cut(get_config(arch))
        assert (cut.num_heads, cut.num_kv_heads, cut.head_dim) == (
            full.num_heads, full.num_kv_heads, full.head_dim), arch
        assert (cut.ssm_heads, cut.ssm_head_dim, cut.ssm_state,
                cut.ssm_chunk) == (full.ssm_heads, full.ssm_head_dim,
                                   full.ssm_state, full.ssm_chunk), arch
        assert (cut.qkv_bias, cut.frontend, cut.attention) == (
            full.qkv_bias, full.frontend, full.attention), arch
        assert dataclasses.asdict(cut) == dataclasses.asdict(
            _cut(ref_config(arch))), arch
    assert get_config("mamba2-2_7b").ssm_heads == 80


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_and_decode_at_the_published_heads(arch):
    cfg, ref, params, port = _pair(arch)
    B, S = (1, 300) if cfg.uses_ssm else (2, 40)
    rng = np.random.default_rng(11)
    if cfg.frontend != "none":
        key = "embeds"
        x = (rng.standard_normal((B, S + DECODE_STEPS, cfg.d_model)) * 0.02
             ).astype(np.float32)
    else:
        key = "tokens"
        x = rng.integers(0, cfg.vocab_size,
                         (B, S + DECODE_STEPS)).astype(np.int32)
    want_logits, want_cache = jax.jit(ref.prefill)(params, {key: x[:, :S]})
    got_logits, got_cache = port.prefill({key: x[:, :S]})
    _close(got_logits, want_logits, f"{arch}: prefill logits")
    want_cache = ref.extend_cache(want_cache, DECODE_STEPS)
    got_cache = port.extend_cache(got_cache, DECODE_STEPS)
    step = jax.jit(ref.decode_step)
    for t in range(DECODE_STEPS):
        inp = x[:, S + t:S + t + 1]
        want_logits, want_cache = step(params, want_cache, {key: inp})
        got_logits, got_cache = port.decode_step(got_cache, {key: inp})
        _close(got_logits, want_logits, f"{arch}: decode step {t + 1}")
    assert got_cache["pos"] == S + DECODE_STEPS


@pytest.mark.parametrize("arch", ZOO)
def test_loss_and_grads_at_the_published_heads(arch):
    chunk = ({"ssm_chunk": SSM_GRAD_CHUNK} if ref_config(arch).uses_ssm
             else {})     # where the reference's gradient stays finite
    cfg, ref, params, port = _pair(arch, **chunk)
    batch = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=40, global_batch=2, seed=5,
        embed_dim=cfg.d_model if cfg.frontend != "none" else 0)).batch(0)
    want_loss, want = jax.jit(jax.value_and_grad(ref.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    port.requires_grad_(True)
    loss = port.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert np.isfinite(float(want_loss))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=TOL)
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            elif prefix.startswith("layers."):
                for j in range(v.shape[0]):      # stacked over the layers
                    flat[f"layers.{j}.{prefix[7:]}{k}"] = np.asarray(v[j])
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(jax.tree_util.tree_map(np.asarray, want))
    got = {n: p.grad for n, p in port.named_parameters()}
    assert sorted(got) == sorted(flat)
    for name, w in flat.items():     # a stub's token table: no gradient
        w = w.astype(np.float64)
        assert np.isfinite(w).all(), f"{arch}: the reference's {name}"
        g = (np.zeros_like(w) if got[name] is None
             else got[name].double().numpy())
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= TOL, (arch, name, err)
