"""The port's model stack (``repro_torch.models``) against the reference
model (``repro.models.Model``) on the CPU, for every architecture at its
tiny config (float32), the MoE ones (dbrx-132b, llama4-maverick-400b-a17b)
included.

Weights are the reference's ``Model.init(PRNGKey(0))`` loaded into the port
through ``params_from_reference``; tokens (or stub-frontend embeddings) are
made with numpy from a seed.  S = 40 crosses the tiny sliding window (32)
and five SSD chunks (8).  Tolerance 1e-4 (rtol and atol) on float32 logits
and caches: the two stacks sum in different orders (the port's K2 plain
version takes a full softmax where the reference scans KV chunks, and the
port's chunk recurrence is a loop where the reference's is an associative
scan).  The tiny MoE configs' capacity factor of 8 keeps every token's
experts (no drops), as in the reference's own tests, so prefill and decode
agree.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_config
from repro.configs import get_tiny_config as ref_tiny_config
from repro.models import Model as RefModel
from repro_torch.configs import ARCH_IDS, get_config, get_tiny_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_reference

B, S, DECODE_STEPS = 2, 40, 4
TOL = 1e-4
TEXT = [a for a in ARCH_IDS if get_config(a).frontend == "none"]


def _pair(arch):
    cfg = ref_tiny_config(arch)
    ref = RefModel(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    port = params_from_reference(get_tiny_config(arch), tree, device="cpu")
    return cfg, ref, params, port


def _inputs(cfg, seed, steps):
    """A prompt of S positions and ``steps`` single-position decode inputs,
    as numpy arrays (tokens, or embeddings for a stub frontend)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend != "none":
        x = (rng.standard_normal((B, S + steps, cfg.d_model)) * 0.02
             ).astype(np.float32)
        key = "embeds"
    else:
        x = rng.integers(0, cfg.vocab_size, (B, S + steps)).astype(np.int32)
        key = "tokens"
    return key, x[:, :S], [x[:, S + t:S + t + 1] for t in range(steps)]


def _close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                               np.float32),
                               rtol=TOL, atol=TOL, err_msg=what)


def test_configs_are_the_reference_configs():
    assert ARCH_IDS == REF_ARCH_IDS
    for arch in ARCH_IDS:      # two classes of the same fields and values
        assert (dataclasses.asdict(get_config(arch))
                == dataclasses.asdict(ref_config(arch)))
        assert (dataclasses.asdict(get_tiny_config(arch))
                == dataclasses.asdict(ref_tiny_config(arch)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logits_match_reference(arch):
    cfg, ref, params, port = _pair(arch)
    key, prompt, _ = _inputs(cfg, 1, 0)
    want = ref.logits(params, {key: prompt})
    got = port.logits({key: prompt})
    assert got.dtype == torch.float32
    _close(got, want, f"{arch}: logits")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_reference(arch):
    cfg, ref, params, port = _pair(arch)
    key, prompt, steps = _inputs(cfg, 2, DECODE_STEPS)
    want_logits, want_cache = jax.jit(ref.prefill)(params, {key: prompt})
    got_logits, got_cache = port.prefill({key: prompt})
    _close(got_logits, want_logits, f"{arch}: prefill logits")
    assert sorted(got_cache) == sorted(want_cache)

    want_cache = ref.extend_cache(want_cache, DECODE_STEPS)
    got_cache = port.extend_cache(got_cache, DECODE_STEPS)
    step = jax.jit(ref.decode_step)
    for t, x in enumerate(steps, 1):
        want_logits, want_cache = step(params, want_cache, {key: x})
        got_logits, got_cache = port.decode_step(got_cache, {key: x})
        _close(got_logits, want_logits, f"{arch}: decode step {t} logits")
        assert got_cache["pos"] == int(want_cache["pos"]) == S + t
        for name in sorted(k for k in want_cache if k != "pos"):
            _close(got_cache[name], want_cache[name],
                   f"{arch}: decode step {t} cache {name!r}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_matches_reference(arch):
    cfg = get_tiny_config(arch)
    want = RefModel(ref_tiny_config(arch)).init_cache(3, 11)
    got = Model(cfg, device="cpu").init_cache(3, 11)
    assert sorted(got) == sorted(want) and got["pos"] == int(want["pos"]) == 0
    for name in (k for k in want if k != "pos"):
        assert tuple(got[name].shape) == want[name].shape, name
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
        assert not got[name].any()


@pytest.mark.parametrize("arch", TEXT)
def test_greedy_tokens_match_reference(arch):
    """Greedy continuations of a prompt: prefill, then each argmax fed
    back through ``decode_step``; the same token ids on both sides."""
    cfg, ref, params, port = _pair(arch)
    key, prompt, _ = _inputs(cfg, 3, 0)
    want_logits, want_cache = jax.jit(ref.prefill)(params, {key: prompt})
    got_logits, got_cache = port.prefill({key: prompt})
    want_cache = ref.extend_cache(want_cache, DECODE_STEPS)
    got_cache = port.extend_cache(got_cache, DECODE_STEPS)
    step = jax.jit(ref.decode_step)
    want_toks, got_toks = [], []
    for _ in range(DECODE_STEPS):
        want_toks.append(np.asarray(want_logits).argmax(-1))
        got_toks.append(got_logits.argmax(-1).numpy())
        want_logits, want_cache = step(params, want_cache,
                                       {key: want_toks[-1][:, None]})
        got_logits, got_cache = port.decode_step(
            got_cache, {key: torch.from_numpy(got_toks[-1][:, None])})
    np.testing.assert_array_equal(np.stack(got_toks), np.stack(want_toks))


def test_llama4_groups_convert_row_for_row():
    """llama4's layers come in groups of ``moe_every`` = 2 (dense, then
    MoE); the reference stacks sub-layer ``s{i}`` over the groups, and row
    j of ``s{i}`` is the port's layer ``j * 2 + i``.  A missing, left-over
    or misshapen leaf raises."""
    arch = "llama4-maverick-400b-a17b"
    cfg = dataclasses.replace(ref_tiny_config(arch), num_layers=4)
    tree = jax.tree_util.tree_map(
        np.asarray, RefModel(cfg).init(jax.random.PRNGKey(0)))
    port_cfg = dataclasses.replace(get_tiny_config(arch), num_layers=4)
    port = params_from_reference(port_cfg, tree, device="cpu")
    for j in range(2):
        for i in range(2):
            layer = port.layers[j * 2 + i]
            assert hasattr(layer, "moe") == (i == 1)
            assert hasattr(layer, "mlp") == (i == 0)
            np.testing.assert_array_equal(
                layer.attn.wq.numpy(), tree["layers"][f"s{i}"]["attn"]["wq"][j])
        np.testing.assert_array_equal(
            port.layers[j * 2 + 1].moe.w_in.numpy(),
            tree["layers"]["s1"]["moe"]["w_in"][j])
    assert port.layers[0].cfg.num_experts == 0
    assert port.layers[0].cfg.shared_expert_ff == 0
    missing = {**tree, "layers": {"s0": tree["layers"]["s0"]}}
    with pytest.raises(RuntimeError, match="Missing"):
        params_from_reference(port_cfg, missing, device="cpu")
    extra = {**tree, "layers": {**tree["layers"],
                                "s2": tree["layers"]["s0"]}}
    with pytest.raises(ValueError, match="s0..s1"):
        params_from_reference(port_cfg, extra, device="cpu")
    short = {**tree, "layers": jax.tree_util.tree_map(
        lambda a: a[:1], tree["layers"])}
    with pytest.raises(ValueError, match="leading axis"):
        params_from_reference(port_cfg, short, device="cpu")


def test_cuda_model_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Model(get_tiny_config("hymba-1_5b"))      # the default device


def test_params_from_reference_defaults_to_the_card():
    """Like ``Model``, the carrier of the reference's weights builds on the
    card unless told otherwise: without one, the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    arch = "hymba-1_5b"
    tree = jax.tree_util.tree_map(np.asarray, RefModel(
        ref_tiny_config(arch)).init(jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_reference(get_tiny_config(arch), tree)
    port = params_from_reference(get_tiny_config(arch), tree, device="cpu")
    assert port.device == torch.device("cpu")


def test_seeded_weights_are_reproducible():
    cfg = get_tiny_config("hymba-1_5b")
    a = Model(cfg, device="cpu",
              generator=torch.Generator().manual_seed(3))
    b = Model(cfg, device="cpu",
              generator=torch.Generator().manual_seed(3))
    for (na, pa), (nb, pb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    assert a.windows == [0, 32]                   # global layer 0, then SWA
