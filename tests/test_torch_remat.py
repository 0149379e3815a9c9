"""``remat="dots"`` (``models.transformer``): the reference's
``jax.checkpoint`` policy ``dots_with_no_batch_dims_saveable`` as a
selective checkpoint of each layer, on the CPU at the tiny configs of
four architectures: hymba (attention and SSM), minicpm3 (MLA), dbrx
(MoE) and llama4 (a group of one dense and one MoE layer).

* What one group keeps for the backward: the reference's residuals are
  ``jax._src.ad_checkpoint.saved_residuals`` of one group under the
  policy, less the group's arguments (its parameters and input).  The
  port's are the outputs its policy saved (the selective checkpoint's
  cache) and, for a group of g > 1 layers, the inputs of layers 2..g,
  which the port's per-layer checkpoints keep where the reference's
  per-group one keeps the product that produces them.  The two multisets
  of (shape, dtype) are equal, a reference shape (B, S, ...) read as the
  port's (B·S, its other dims' product): the port's projections multiply
  the folded tokens (``aten.mm``).
* The gradients under ``"dots"`` are bit-equal to ``"none"``'s: the
  recomputation is the same arithmetic.
* The loss and every gradient against ``jax.grad`` of the reference at
  ``remat="dots"``, at the tolerances of ``tests/test_torch_train_step.py``.
"""
import collections
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.utils import checkpoint as torch_checkpoint
from torch.utils._pytree import tree_leaves

from repro.configs import get_tiny_config as ref_tiny_config
from repro.models import Model as RefModel
from repro.models.transformer import group_forward
from repro_torch.configs import get_tiny_config
from repro_torch.models import Model
from repro_torch.models import transformer
from test_torch_train_step import (B, GRAD_RTOL, LOSS_RTOL, S, _batch,
                                   _flat_grads, _grad_errors, _pair,
                                   _port_batch, _port_grads)

ARCHS = ["hymba-1_5b", "minicpm3-4b", "dbrx-132b",
         "llama4-maverick-400b-a17b"]


def _canonical(shape, dtype) -> tuple:
    shape = tuple(shape)
    if shape[:2] == (B, S):
        shape = (B * S, math.prod(shape[2:]))
    return shape, str(dtype).removeprefix("torch.")


def _reference_residuals(arch) -> collections.Counter:
    cfg = dataclasses.replace(ref_tiny_config(arch), remat="dots")
    params = RefModel(cfg).init(jax.random.PRNGKey(0))
    group = jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    x = jnp.ones((B, S, cfg.d_model), cfg.dtype)
    body = jax.checkpoint(
        lambda p, xx: group_forward(p, xx, cfg, window=0), prevent_cse=False,
        policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
    return collections.Counter(
        _canonical(aval.shape, aval.dtype)
        for aval, src in saved_residuals(body, group, x)
        if not src.startswith("from the argument"))


def _port_saved(arch) -> list[collections.Counter]:
    """Per group of layers, what the port's forward under ``"dots"`` keeps
    for the backward: the outputs the selective checkpoint cached and the
    inputs of every layer but the group's first."""
    cfg = dataclasses.replace(get_tiny_config(arch), remat="dots")
    model = Model(cfg, device="cpu")
    model.requires_grad_(True)
    caches, inputs = [], []
    make = transformer._dots_contexts

    def recording(blk):
        contexts = make(blk)
        caches.append(contexts[0].storage)
        return contexts

    hooks = [blk.register_forward_pre_hook(
        lambda m, args, i=i: inputs.append((i, args[0])))
        for i, blk in enumerate(model.layers)]
    transformer._dots_contexts = recording
    try:
        model.hidden_states(_port_batch(_batch(cfg)))
    finally:
        transformer._dots_contexts = make
        for h in hooks:
            h.remove()
    g = len(transformer._sub_cfgs(cfg))
    assert len(caches) == cfg.num_layers == len(inputs)
    groups = [collections.Counter() for _ in range(cfg.num_layers // g)]
    for i, storage in enumerate(caches):
        for entries in storage.values():
            for e in (entries.values() if isinstance(entries, dict)
                      else entries):
                if e is getattr(torch_checkpoint, "_RECOMPUTE", None):
                    continue
                for t in tree_leaves(e):
                    groups[i // g][_canonical(t.val.shape, t.val.dtype)] += 1
    for i, x in inputs:
        if i % g:
            groups[i // g][_canonical(x.shape, x.dtype)] += 1
    return groups


@pytest.mark.parametrize("arch", ARCHS)
def test_saved_tensors_equal_the_reference_residuals(arch):
    want = _reference_residuals(arch)
    assert want and sum(want.values()) >= 5
    for got in _port_saved(arch):
        assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_gradients_equal_no_remat(arch):
    cfg = get_tiny_config(arch)
    batch = _batch(cfg)
    got = {}
    for remat in ("none", "dots"):
        model = Model(dataclasses.replace(cfg, remat=remat), device="cpu")
        got[remat] = _port_grads(model, batch)
    (loss_a, a), (loss_b, b) = got["none"], got["dots"]
    assert torch.equal(loss_a, loss_b)
    assert sorted(a) == sorted(b)
    for name in a:
        assert (a[name] is None and b[name] is None) or torch.equal(
            a[name], b[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_loss_and_grads_match_reference(arch):
    cfg, ref, params, port = _pair(arch, remat="dots")
    assert port.cfg.remat == "dots"
    batch = _batch(cfg)
    want_loss, want = jax.jit(jax.value_and_grad(ref.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, got = _port_grads(port, batch)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_RTOL)
    want = _flat_grads(jax.tree_util.tree_map(np.asarray, want),
                       groups=cfg.moe_every if cfg.uses_moe else 1)
    if cfg.experts_per_token == 1:
        # top-1: the router's exact gradient is zero, both sides hold
        # rounding noise (as in tests/test_torch_train_step.py)
        total = np.sqrt(sum(np.linalg.norm(w) ** 2 for w in want.values()))
        for name in [n for n in want if n.endswith(".moe.router")]:
            assert np.linalg.norm(want.pop(name)) <= 1e-6 * total, name
            assert float(got.pop(name).norm()) <= 1e-6 * total, name
    errs = _grad_errors(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])


def test_an_unknown_remat_is_refused():
    cfg = dataclasses.replace(get_tiny_config("stablelm-12b"),
                              remat="offload")
    model = Model(cfg, device="cpu")
    with pytest.raises(ValueError, match="offload"):
        model.loss(_port_batch(_batch(cfg)))
