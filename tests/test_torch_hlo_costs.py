"""The port's cost accounting (``repro_torch.launch.hlo_costs``) and the
kernels as operators (``torch.ops.repro_torch.*``), on the CPU.

* The counterpart of ``test_hlo_cost_model_scan_multiplication``: the
  reference multiplies a scanned body by its trip count; eager PyTorch
  dispatches every trip, so 12 products of 256² float32 count exactly
  12·2·256³.
* Each kernel operator's fake implementation gives its plain version's
  output shapes and dtypes (float32 and bfloat16, GQA, grouped B/C).
* Each flop formula equals a brute-force count: K2 and K2-bwd over the
  mask's kept (query, key) pairs (``ref._band``) at windows 0, 5 and 32,
  causal and not, with GQA; K3 and K3-bwd over each chunk's kept (q, t)
  pairs; K1 2·M·N·K — and ``FlopCounterMode`` reads the same through the
  operators.  ``analyze`` applies the same formulas and counts what
  ``FlopCounterMode`` counts on every configuration's steps.
* Bytes: an operator is billed its operands and outputs, a view nothing,
  an indexed read its rows, K2 its scores' traffic as flash-loop bytes; a
  collective its operand per kind, on a fake process group.
"""
import importlib
import itertools

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_tiny_config
from repro_torch.kernels import (flash_attention, flash_attention_bwd, matmul,
                                 ssd_chunk, ssd_chunk_bwd)
from repro_torch.kernels.ref import _band
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_costs import COLLECTIVES, analyze, breakdown
from repro_torch.launch.specs import ShapeSpec

fa = importlib.import_module("repro_torch.kernels.flash_attention")


def test_loop_of_products_counts_every_trip():
    """12 dispatched 256² float32 products: exactly 12·2·256³ FLOPs (the
    reference needs the scan's trip count for this; eager dispatch sees
    every trip)."""
    a = torch.randn(256, 256)
    ws = torch.randn(12, 256, 256)

    def f(x, ws):
        for w in ws:
            x = x @ w
        return x

    r = analyze(f, a, ws)
    assert r["flops"] == 12 * 2 * 256 ** 3
    # each product reads x and w (256² f32 each) and writes x; the loop's
    # ``ws[i]`` is a view, billed nothing
    assert r["bytes_kernelized"] == 12 * 3 * 256 * 256 * 4
    assert r["flash_loop_bytes"] == 0 and r["bytes"] == r["bytes_kernelized"]
    assert r["collective_counts"] == {k: 0 for k in COLLECTIVES}


def _attn_inputs(B, S, H, KH, Dk, Dv, dtype, g):
    q = torch.randn(B, S, H, Dk, generator=g).to(dtype)
    k = torch.randn(B, S, KH, Dk, generator=g).to(dtype)
    v = torch.randn(B, S, KH, Dv, generator=g).to(dtype)
    return q, k, v


def _ssd_inputs(b, nc, Q, nh, G, hp, ds, dtype, g):
    xdt = torch.randn(b, nc, Q, nh, hp, generator=g).to(dtype)
    B = torch.randn(b, nc, Q, G, ds, generator=g).to(dtype)
    C = torch.randn(b, nc, Q, G, ds, generator=g).to(dtype)
    cum = torch.cumsum(-torch.rand(b, nc, Q, nh, generator=g), dim=2)
    return xdt, B, C, cum


def _meta(xs):
    return [x.to("meta") for x in xs]


def _fake(xs):
    mode = FakeTensorMode()
    return mode, [mode.from_tensor(x) for x in xs]


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (tuple(a.shape), a.dtype) == (tuple(b.shape), b.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_outputs_match_the_plain_versions(dtype):
    """Every operator on meta tensors and under ``FakeTensorMode`` gives
    the shapes and dtypes its plain version (CPU) gives."""
    g = torch.Generator().manual_seed(0)
    q, k, v = _attn_inputs(2, 24, 6, 2, 16, 8, dtype, g)
    ssd = _ssd_inputs(1, 2, 8, 4, 2, 8, 16, dtype, g)
    a, b = torch.randn(5, 7, generator=g).to(dtype), torch.randn(
        7, 3, generator=g).to(dtype)
    o, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, True, 5, None)
    do = torch.randn(o.shape, generator=g).to(dtype)
    y, st = ssd_chunk(*ssd)
    cases = [
        (torch.ops.repro_torch.flash_attention, (q, k, v), (True, 5, None)),
        (torch.ops.repro_torch.flash_attention_lse, (q, k, v),
         (False, 0, 0.5)),
        (torch.ops.repro_torch.flash_attention_bwd, (q, k, v, o, do, lse),
         (True, 5, None)),
        (torch.ops.repro_torch.ssd_chunk, ssd, ()),
        (torch.ops.repro_torch.ssd_chunk_bwd,
         (*ssd, torch.randn(y.shape, generator=g).to(dtype),
          torch.randn(st.shape, generator=g)), ()),
        (torch.ops.repro_torch.matmul, (a, b), ()),
    ]
    for op, tensors, rest in cases:
        want = op(*tensors, *rest)
        _same(op(*_meta(tensors), *rest), want)
        mode, fakes = _fake(tensors)
        with mode:
            _same(op(*fakes, *rest), want)


def _brute_pairs(S, causal, window):
    return int(_band(S, S, causal, window, "cpu").sum())


@pytest.mark.parametrize("causal,window", list(itertools.product(
    [True, False], [0, 5, 32])))
def test_attention_flops_count_the_kept_pairs(causal, window):
    B, S, H, KH, Dk, Dv = 2, 40, 6, 2, 16, 8
    pairs = _brute_pairs(S, causal, window)
    assert fa.band_pairs(S, S, causal, window) == pairs
    g = torch.Generator().manual_seed(1)
    q, k, v = _attn_inputs(B, S, H, KH, Dk, Dv, torch.float32, g)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    with FlopCounterMode(display=False) as fwd:
        o = flash_attention(q, k, v, causal=causal, window=window)
    assert fwd.get_total_flops() == 2 * B * H * (Dk + Dv) * pairs
    out = flash_attention(qr, kr, vr, causal=causal, window=window)
    with FlopCounterMode(display=False) as bwd:
        out.backward(torch.ones_like(out))
    assert bwd.get_total_flops() == 2 * B * H * (4 * Dk + 3 * Dv) * pairs
    lse = torch.ops.repro_torch.flash_attention_lse(
        q, k, v, causal, window, None)[1]
    with FlopCounterMode(display=False) as direct:
        flash_attention_bwd(q, k, v, o, torch.ones_like(o), lse,
                            causal=causal, window=window)
    assert direct.get_total_flops() == bwd.get_total_flops()
    # the plain version's scores and probabilities, f32, written and read
    r = analyze(flash_attention, q, k, v, causal=causal, window=window)
    assert r["flash_loop_bytes"] == 2 * 2 * 4 * B * H * S * S
    assert r["bytes_kernelized"] == sum(x.numel() * 4 for x in (q, k, v, o))


@pytest.mark.parametrize("Q", [8, 13])
def test_ssd_flops_count_the_kept_pairs(Q):
    b, nc, nh, G, hp, ds = 2, 3, 4, 2, 8, 16
    pairs = int(torch.tril(torch.ones(Q, Q)).sum())
    g = torch.Generator().manual_seed(2)
    ins = _ssd_inputs(b, nc, Q, nh, G, hp, ds, torch.float32, g)
    with FlopCounterMode(display=False) as fwd:
        y, st = ssd_chunk(*ins)
    assert fwd.get_total_flops() == 2 * b * nc * nh * (
        pairs * (ds + hp) + Q * ds * hp)
    with FlopCounterMode(display=False) as bwd:
        ssd_chunk_bwd(*ins, torch.ones_like(y), torch.ones_like(st))
    assert bwd.get_total_flops() == 2 * b * nc * (
        pairs * (nh * 2 * hp + G * 3 * ds) + nh * 2 * Q * ds * hp)


def test_matmul_flops_and_launch_counts():
    a, b = torch.randn(5, 7), torch.randn(7, 3)
    before = matmul.launches
    with FlopCounterMode(display=False) as fc:
        c = matmul(a, b)
    assert fc.get_total_flops() == 2 * 5 * 7 * 3
    torch.testing.assert_close(c, a @ b)
    assert matmul.launches == before      # the plain version launches none


def test_views_are_free_and_gathers_bill_their_rows():
    table = torch.randn(1000, 64)
    idx = torch.tensor([[1, 5, 7]])
    r = analyze(lambda t, i: t[i], table, idx)
    assert r["bytes"] == 2 * 3 * 64 * 4 + idx.numel() * 8
    r = analyze(lambda t: t.T.reshape(-1)[:10], table)   # a copy, no views
    assert r["bytes"] == 2 * table.numel() * 4


def test_breakdown_ranks_operators():
    a = torch.randn(64, 64)
    top = breakdown(lambda x: (x @ x).sin().sum(), a, top=3)
    assert top["flops"][0] == ("aten.mm", 2 * 64 ** 3)
    assert [name for name, _ in top["bytes"]][0] in ("aten.mm", "aten.sin")


def test_collectives_on_a_fake_group():
    """A c10d all-reduce and a DTensor redistribution's functional
    all-gather are each counted once, at their operand's bytes."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("data",))
        x = torch.randn(8, 16)
        d = DTensor.from_local(torch.randn(2, 16), mesh, (Shard(0),),
                               run_check=False)

        def f():
            dist.all_reduce(x)
            return d.redistribute(mesh, (Replicate(),)).to_local()

        r = analyze(f)
    finally:
        dist.destroy_process_group()
    assert r["collective_counts"]["all-reduce"] == 1
    assert r["collective_bytes"]["all-reduce"] == x.numel() * 4
    assert r["collective_counts"]["all-gather"] == 1
    assert r["collective_bytes"]["all-gather"] == 2 * 16 * 4


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analyze_counts_what_flop_counter_mode_counts(arch):
    """``analyze`` applies ``FlopCounterMode``'s formulas without entering
    it (its module tracker keeps tensors alive): on every configuration's
    train, prefill and decode steps (tiny, one device, seeded) the two
    counts are equal."""
    cfg = get_tiny_config(arch)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec(kind, kind, 24, 2)
        cell = dryrun.build_cell(cfg, shape, None, device="cpu", fake=False)
        with FlopCounterMode(display=False) as fc:
            cell.run()
        cell = dryrun.build_cell(cfg, shape, None, device="cpu", fake=False)
        got = analyze(cell.run)["flops"]
        assert got == fc.get_total_flops() > 0, (kind, got)
