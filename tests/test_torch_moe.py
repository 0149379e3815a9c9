"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) on the CPU.

Both take the parameters of the reference's ``init_moe(PRNGKey(0))`` (the
port's through the state dict), and the same tokens made with numpy from a
seed, at the tiny configs of dbrx-132b (4 experts, top-2) and
llama4-maverick-400b-a17b (top-1 and a shared expert).  float32 is held at
rtol 1e-5 / atol 1e-6 (the two sum a token's k contributions in different
orders); bfloat16 at rtol 1e-2 and atol 1e-2 of the reference's largest
magnitude (the expert products round to bf16 on both sides, in different
orders; the outputs are ~1e-3 at these widths, so a fixed atol would pass
anything), a gate that a zeroed output and a combine that drops a choice
both fail.  Where capacity binds, the kept
(token, choice) -> (expert, slot) pairs must be the same set, which holds
only if both sort stably; an all-zero router makes every probability
equal, so top-k must break ties to the lower expert id, as
``jax.lax.top_k`` does.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as ref_tiny_config
from repro.models import moe as ref_moe
from repro_torch.configs import get_config, get_tiny_config
from repro_torch.launch import serve, train
from repro_torch.models import moe
from repro_torch.models.convert import _tensor
from repro_torch.models.layers import Init

ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]
# (rtol, atol as a share of max |reference|) for bf16; float32's atol is
# absolute
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (1e-2, 1e-2)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = _tensor(v)
    return out


def _pair(arch, dtype="float32", zero_router=False):
    """The reference config and parameters, and the port's ``MoE`` holding
    the same values."""
    cfg = dataclasses.replace(ref_tiny_config(arch), dtype=dtype)
    p = ref_moe.init_moe(jax.random.PRNGKey(0), cfg)
    if zero_router:
        p["router"] = jnp.zeros_like(p["router"])
    p = jax.tree_util.tree_map(np.asarray, p)
    layer = moe.MoE(dataclasses.replace(get_tiny_config(arch), dtype=dtype),
                    Init(torch.device("cpu"), torch.Generator()))
    layer.load_state_dict(_flat(p), strict=True)
    return cfg, p, layer


def _tokens(cfg, T, seed=1):
    x = np.random.default_rng(seed).standard_normal((T, cfg.d_model))
    return x.astype(np.float32)


def _both(arch, dtype, T, *, e_off=0, num_local=None, capacity=None,
          zero_router=False):
    cfg, p, layer = _pair(arch, dtype, zero_router)
    n = cfg.num_experts if num_local is None else num_local
    C = moe.capacity_for(T, cfg) if capacity is None else capacity
    x = _tokens(cfg, T)
    # the reference's moe_local holds only its shard's experts, as the
    # body of its expert-parallel path hands them over
    local = dict(p, **{w: p[w][e_off:e_off + n]
                       for w in ("w_in", "w_gate", "w_out")})
    want, want_counts = ref_moe.moe_local(
        local, jnp.asarray(x, dtype=getattr(jnp, dtype)), cfg, e_off=e_off,
        num_local=n, capacity=C)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got, counts = layer.moe_local(xt, e_off=e_off, num_local=n, capacity=C)
    return cfg, p, layer, x, (want, want_counts), (got, counts), (n, C)


def _close(got, want, dtype, what):
    rtol, atol = TOL[dtype]
    want = np.asarray(want, np.float32)
    if dtype == "bfloat16":
        atol *= float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol, err_msg=what)


def _reference_slots(p, x, cfg, *, e_off, num_local, capacity):
    """The reference's dispatch (``moe_local``'s routing, sort and slot
    steps) as a set of kept (token, choice, expert, slot)."""
    T, k = x.shape[0], cfg.experts_per_token
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, k)
    eid = top_i.reshape(-1)
    local = (eid >= e_off) & (eid < e_off + num_local)
    eid_l = jnp.where(local, eid - e_off, num_local)
    order = jnp.argsort(eid_l, stable=True)
    eid_s = eid_l[order]
    counts = jnp.bincount(eid_s, length=num_local + 1)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(eid_s.size) - starts[eid_s]
    keep = np.asarray((pos < capacity) & (eid_s < num_local))
    order, eid_s, pos = (np.asarray(a) for a in (order, eid_s, pos))
    return {(int(o) // k, int(o) % k, int(e), int(c))
            for o, e, c, kept in zip(order, eid_s, pos, keep) if kept}


def _port_slots(layer, x, *, e_off, num_local, capacity):
    _, top_i = moe.route(torch.from_numpy(x), layer.router,
                         layer.cfg.experts_per_token)
    slot, keep = moe.dispatch(top_i, e_off=e_off, num_local=num_local,
                              capacity=capacity)
    return {(t, j, int(slot[t, j]) // capacity, int(slot[t, j]) % capacity)
            for t, j in zip(*np.nonzero(keep.numpy()))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_local_matches_reference(arch, dtype):
    *_, (want, want_counts), (got, counts), _ = _both(arch, dtype, 48)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype, f"{arch} {dtype}: moe_local")
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, dtype):
    """The layer over (B, S, d), capacity from B·S, the shared expert
    (llama4) added."""
    cfg, p, layer = _pair(arch, dtype)
    x = _tokens(cfg, 2 * 24).reshape(2, 24, cfg.d_model)
    want = ref_moe.moe_block(p, jnp.asarray(x, dtype=getattr(jnp, dtype)),
                             cfg)
    got = layer(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert hasattr(layer, "shared") == bool(cfg.shared_expert_ff)
    _close(got, want, dtype, f"{arch} {dtype}: MoE block")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_gate_rejects_a_wrong_output(arch, monkeypatch):
    """The bf16 gate above is tight enough to see a fault: an all-zero
    output fails it, and so does a combine that drops each token's last
    choice (for top-1 llama4, its only one; the block's shared expert
    still adds its part)."""
    cfg, p, layer = _pair(arch, "bfloat16")
    x = _tokens(cfg, 2 * 24).reshape(2, 24, cfg.d_model)
    want = ref_moe.moe_block(p, jnp.asarray(x, dtype=jnp.bfloat16), cfg)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    _close(layer(xt), want, "bfloat16", f"{arch}: the right output")
    with pytest.raises(AssertionError):
        _close(torch.zeros(want.shape), want, "bfloat16", "zeros")
    dispatch = moe.dispatch

    def drop_last_choice(top_i, **kw):
        slot, keep = dispatch(top_i, **kw)
        keep = keep.clone()
        keep[:, -1] = False
        return slot, keep

    monkeypatch.setattr(moe, "dispatch", drop_last_choice)
    with pytest.raises(AssertionError):
        _close(layer(xt), want, "bfloat16", "a choice dropped")


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_binds_and_drops_the_reference_tokens(arch):
    """T = 64, C = 8: experts overflow and drop pairs; the kept pairs, the
    counts and the outputs equal the reference's."""
    T, C = 64, 8
    cfg, p, layer, x, (want, want_counts), (got, counts), (n, _) = _both(
        arch, "float32", T, capacity=C)
    ref_kept = _reference_slots(p, x, cfg, e_off=0, num_local=n,
                                capacity=C)
    kept = _port_slots(layer, x, e_off=0, num_local=n, capacity=C)
    assert kept == ref_kept
    assert len(kept) < T * cfg.experts_per_token       # capacity did bind
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    _close(got, want, "float32", f"{arch}: capacity 8")


@pytest.mark.parametrize("arch", ARCHS)
def test_partial_expert_range(arch):
    """Experts [2, 4) only, the building block of the expert-parallel
    path: pairs routed elsewhere go to the dustbin and add nothing."""
    cfg, p, layer, x, (want, _), (got, counts), (n, C) = _both(
        arch, "float32", 40, e_off=2, num_local=2)
    _close(got, want, "float32", f"{arch}: experts [2, 4)")
    assert _port_slots(layer, x, e_off=2, num_local=2, capacity=C) == \
        _reference_slots(p, x, cfg, e_off=2, num_local=2, capacity=C)
    assert counts.sum() == 40 * cfg.experts_per_token   # global ids counted


@pytest.mark.parametrize("arch", ARCHS)
def test_all_zero_router_breaks_ties_like_top_k(arch):
    """Every probability equal: experts 0..k-1, in that order, for every
    token, as ``jax.lax.top_k`` picks them, and the reference's output."""
    cfg, p, layer, x, (want, want_counts), (got, _), (n, C) = _both(
        arch, "float32", 32, zero_router=True, capacity=16)
    k = cfg.experts_per_token
    top_w, top_i = moe.route(torch.from_numpy(x), layer.router, k)
    assert top_i.tolist() == [list(range(k))] * 32
    assert torch.equal(top_w, torch.full((32, k), 1.0 / k))
    _close(got, want, "float32", f"{arch}: all-zero router")
    assert _port_slots(layer, x, e_off=0, num_local=n, capacity=C) == \
        _reference_slots(p, x, cfg, e_off=0, num_local=n, capacity=C)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_for_matches_reference(arch):
    for cfg in (get_config(arch), get_tiny_config(arch)):
        for tokens in (1, 5, 64, 2776, 13880):
            assert moe.capacity_for(tokens, cfg) == ref_moe.capacity_for(
                tokens, cfg)
    assert moe.capacity_for(5 * 2776, get_config("dbrx-132b")) == 4344


@pytest.mark.parametrize("arch,T,C", [("dbrx-132b", 48, 16),
                                      ("llama4-maverick-400b-a17b", 48, 8)])
def test_moe_gradients_match_reference(arch, T, C):
    """Autograd through the routing weights, the gathers and the grouped
    products: every routed parameter's and the input's gradient against
    ``jax.grad`` of the reference, with capacity binding.  dbrx's top-2
    at rtol 1e-5; llama4's top-1 renormalises its one weight to p / p = 1,
    so the router's exact gradient is zero and both sides hold rounding
    noise, which must be below 1e-6 of the gradients' norm (as in
    ``tests/test_torch_train_step.py``)."""
    cfg, p, layer = _pair(arch)
    x = _tokens(cfg, T)
    _, keep = moe.dispatch(moe.route(torch.from_numpy(x), layer.router,
                                     cfg.experts_per_token)[1], e_off=0,
                           num_local=cfg.num_experts, capacity=C)
    assert 0 < int(keep.sum()) < T * cfg.experts_per_token   # C binds

    def ref_loss(params, xx):
        out, _ = ref_moe.moe_local(params, xx, cfg, e_off=0,
                                   num_local=cfg.num_experts, capacity=C)
        return jnp.sum(out * jnp.cos(jnp.arange(out.size).reshape(out.shape)))

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    layer.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = layer.moe_local(xt, e_off=0, num_local=cfg.num_experts,
                             capacity=C)
    (out * torch.cos(torch.arange(out.numel(), dtype=torch.float32)
                     .reshape(out.shape))).sum().backward()
    grads = dict(layer.named_parameters())
    want = {name: w for name, w in _flat(jax.tree_util.tree_map(
        np.asarray, want_p)).items() if name in ("router",)
        + moe.MoE.expert_leaves}
    total = math.sqrt(sum(float(w.norm()) ** 2 for w in want.values()))
    for name, w in want.items():
        g = grads[name].grad
        if name == "router" and cfg.experts_per_token == 1:
            assert float(w.norm()) <= 1e-6 * total
            assert float(g.norm()) <= 1e-6 * total
            continue
        err = float((g - w).norm() / w.norm())
        assert err <= 1e-5, (name, err)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x),
                               rtol=1e-5, atol=1e-6)


def test_init_scales_and_dtypes():
    cfg = dataclasses.replace(get_config("dbrx-132b"), d_model=256,
                              d_ff=384, dtype="bfloat16")
    layer = moe.MoE(cfg, Init(torch.device("cpu"),
                              torch.Generator().manual_seed(0)))
    assert layer.router.dtype == torch.float32
    assert {t.dtype for t in (layer.w_in, layer.w_gate, layer.w_out)} == {
        torch.bfloat16}
    assert layer.w_in.shape == layer.w_gate.shape == (16, 256, 384)
    assert layer.w_out.shape == (16, 384, 256)
    out_sc = 0.02 / math.sqrt(2 * cfg.num_layers)
    for t, sc in ((layer.router, 0.02), (layer.w_in, 0.02),
                  (layer.w_gate, 0.02), (layer.w_out, out_sc)):
        assert abs(float(t.float().std()) / sc - 1) < 0.02
    assert not hasattr(layer, "shared")


def test_reruns_are_bit_equal():
    _, _, layer = _pair("dbrx-132b")
    x = torch.from_numpy(_tokens(layer.cfg, 64))
    a, ca = layer.moe_local(x, e_off=0, num_local=4, capacity=8)
    b, cb = layer.moe_local(x, e_off=0, num_local=4, capacity=8)
    assert torch.equal(a, b) and torch.equal(ca, cb)


def test_train_cli_step_under_dots_remat_on_the_cpu():
    """One step of tiny dbrx through ``launch.train``'s objects under
    ``remat="dots"`` (``build``'s ``cfg``): finite, and the loss, the
    gradient norm and every updated parameter equal to the same step
    under ``"none"``."""
    args = train.parse_args(["--tiny", "--device", "cpu", "--arch",
                             "dbrx-132b", "--batch", "2", "--seq", "24",
                             "--steps", "1"])
    runs = []
    for remat in ("none", "dots"):
        cfg = dataclasses.replace(get_tiny_config("dbrx-132b"), remat=remat)
        job = train.build(args, cfg)
        assert job.model.cfg.remat == remat
        _, m = job.step_fn(job.state, job.data.batch(0))
        runs.append((m, {k: p.detach().clone()
                         for k, p in job.model.named_parameters()}))
    (m0, p0), (m1, p1) = runs
    assert np.isfinite(float(m1["loss"])) and float(m1["grad_norm"]) > 0
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_serve_cli_serves_dbrx_on_the_cpu(capsys):
    assert serve.main(["--tiny", "--device", "cpu", "--arch", "dbrx-132b",
                       "--requests", "4", "--max-new", "16"]) == 0
    out = capsys.readouterr().out
    assert "4 completions, 64 tokens" in out
