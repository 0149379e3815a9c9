"""The port's optimizers against the reference on the leaves the reference
stacks over the layers, on the CPU.

The reference keeps a layer's leaves stacked, so a per-layer norm scale or
SSM vector (the port's (d,)) is an (L, d) leaf there: AdamW decays it
(``p.ndim >= 2``) and FactoredAdam factors it into "vr" (L,) and "vc"
(d,).  Tiny hymba (norms, ``A_log``, ``D``, ``conv_b``, ``dt_bias``, the
SSM's norm) and tiny dbrx (MoE) take one step of each optimizer from the
reference's ``Model.init`` weights (``params_from_reference``), with the
same numpy gradients fed to both packages.  Every updated leaf and every
moment is held at rtol 1e-5: the arithmetic is the same float32 sequence,
so only the order of the global norm's sum differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as ref_tiny_config
from repro.models import Model as RefModel
from repro.training import optim as ref_optim
from repro_torch.configs import get_tiny_config
from repro_torch.models.convert import (layer_groups, params_from_reference,
                                        reference_leaf)
from repro_torch.training import optim

RTOL, ATOL = 1e-5, 1e-7
LR = 1e-2


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nest(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _row(arr, row):
    a = np.asarray(jnp.asarray(arr, jnp.float32))
    return a if row is None else a[row]


def _close(got: torch.Tensor, want, what: str) -> None:
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _step(arch, opt_name):
    cfg = ref_tiny_config(arch)
    ref_params = RefModel(cfg).init(jax.random.PRNGKey(0))
    port_cfg = get_tiny_config(arch)
    model = params_from_reference(
        port_cfg, jax.tree_util.tree_map(np.asarray, ref_params),
        device="cpu")
    g = layer_groups(port_cfg)
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    rng = np.random.default_rng(3)
    ref_flat = _flat(ref_params)
    grads_np = {k: rng.standard_normal(np.shape(v)).astype(np.float32)
                for k, v in ref_flat.items()}
    grads = {}
    for k in params:
        ref, row = reference_leaf(k, g)
        grads[k] = torch.from_numpy(np.array(_row(grads_np[ref], row)))
    if opt_name == "AdamW":
        port, ref = optim.AdamW(learning_rate=LR), ref_optim.AdamW(
            learning_rate=LR)
    else:
        port = optim.FactoredAdam(learning_rate=LR, weight_decay=0.1,
                                  layer_groups=g)
        ref = ref_optim.FactoredAdam(learning_rate=LR, weight_decay=0.1)
    state = port.init(params)
    rstate = ref.init(ref_params)
    params, state, _ = port.update(grads, state, params)
    rparams, rstate, _ = ref.update(
        _nest({k: jnp.asarray(v) for k, v in grads_np.items()}), rstate,
        ref_params)
    return g, params, state, _flat(rparams), rstate


@pytest.mark.parametrize("opt_name", ["AdamW", "FactoredAdam"])
@pytest.mark.parametrize("arch", ["hymba-1_5b", "dbrx-132b"])
def test_one_step_matches_reference_on_every_leaf(arch, opt_name):
    g, params, state, rparams, rstate = _step(arch, opt_name)
    stacked_1d = 0
    for k, p in params.items():
        ref, row = reference_leaf(k, g)
        _close(p, _row(rparams[ref], row), f"{arch} {opt_name} param {k}")
        _close(state["m"][k], _row(_flat(rstate["m"])[ref], row),
               f"{arch} {opt_name} m {k}")
        stacked_1d += row is not None and p.dim() == 1
    assert stacked_1d > 0
    if opt_name == "AdamW":
        rv = _flat(rstate["v"])
        for k in params:
            ref, row = reference_leaf(k, g)
            _close(state["v"][k], _row(rv[ref], row), f"{arch} v {k}")
        return
    # FactoredAdam: a stack's 1-D leaves share one "vr"/"vc" pair, kept
    # under the stack's reference name; other leaves keep their own rows
    stacks = set()
    for k, p in params.items():
        ref, row = reference_leaf(k, g)
        want = rstate["v"]
        for part in ref.split("."):
            want = want[part]
        if row is not None and p.dim() == 1:
            got, row = state["v"][ref], None
            stacks.add(ref)
        else:
            got = state["v"][k]
        assert sorted(got) == sorted(want), (k, sorted(got), sorted(want))
        for sub in want:
            _close(got[sub], _row(want[sub], row), f"{arch} {sub} {k}")
    assert stacks and len(state["v"]) == len(params) - sum(
        1 for k, p in params.items()
        if reference_leaf(k)[1] is not None and p.dim() == 1) + len(stacks)


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_adamw_in_row_blocks_is_bit_equal(monkeypatch, state_dtype):
    """AdamW updates a plain leaf of more than ``optim.BLOCK`` elements a
    block of rows at a time (a dbrx-132B expert leaf would otherwise make
    4.2 GB float32 temporaries): with blocks of 3 rows of a (10, 7, 5)
    leaf and of an (11, 13) one, the same leaves, moments and metrics to
    the bit as one block each."""
    shapes = {"layers.0.moe.w_in": (10, 7, 5), "lm_head": (11, 13),
              "final_norm.scale": (13,)}
    results = []
    for block in (10 ** 9, 3 * 7 * 5):
        monkeypatch.setattr(optim, "BLOCK", block)
        rng = np.random.default_rng(3)
        params, grads = ({k: torch.tensor(rng.standard_normal(s),
                                          dtype=torch.float32)
                          for k, s in shapes.items()} for _ in range(2))
        opt = optim.AdamW(learning_rate=LR, state_dtype=state_dtype)
        state = opt.init(params)
        for _ in range(2):
            params, state, metrics = opt.update(grads, state, params)
        results.append((params, state, metrics))
    assert len(optim._row_blocks(*[torch.zeros(10, 7, 5)] * 2)) == 4
    (p1, s1, m1), (p2, s2, m2) = results
    for k in shapes:
        assert torch.equal(p1[k], p2[k]), k
        assert torch.equal(s1["m"][k], s2["m"][k]), k
        assert torch.equal(s1["v"][k], s2["v"][k]), k
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
