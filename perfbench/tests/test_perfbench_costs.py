"""The benchmark's frozen operation counts equal the port's operator
formulas (as ``FlopCounterMode`` applies them) at small shapes, and its
model count equals what the counter sees of a tiny MLA prefill."""
from __future__ import annotations

import json

import pytest
import torch
from conftest import ROOT, TINY
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.kernels  # noqa: F401  (registers torch.ops.repro_torch)
from perfbench.costs import kernels, model

F32, BF16 = torch.float32, torch.bfloat16


def counted(fn) -> int:
    with FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


def _attn_inputs(B, Sq, Skv, H, KH, Dk, Dv, dtype):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, Sq, H, Dk, generator=g).to(dtype)
    k = torch.randn(B, Skv, KH, Dk, generator=g).to(dtype)
    v = torch.randn(B, Skv, KH, Dv, generator=g).to(dtype)
    return q, k, v


ATTN = [  # B, Sq, Skv, H, KH, Dk, Dv, causal, window, q_offset
    (2, 24, 24, 4, 2, 16, 16, True, 0, 0),
    (1, 40, 40, 4, 4, 24, 16, True, 0, 0),
    (2, 16, 48, 2, 1, 16, 8, True, 8, 32),
    (1, 8, 8, 2, 2, 16, 16, False, 0, 0),
]


def _sizes(*ts):
    return [t.element_size() for t in ts]


@pytest.mark.parametrize("case", ATTN)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_attention_counts(case, dtype):
    B, Sq, Skv, H, KH, Dk, Dv, causal, window, off = case
    q, k, v = _attn_inputs(B, Sq, Skv, H, KH, Dk, Dv, dtype)
    ops = torch.ops.repro_torch
    got = counted(lambda: ops.flash_attention(q, k, v, causal, window, None,
                                              off))
    shapes = [tuple(t.shape) for t in (q, k, v)]
    flops, nbytes = kernels.flash_attention(
        shapes, _sizes(q, k, v), [causal, window, None, off])
    assert flops == got
    o_bytes = B * Sq * H * Dv * q.element_size()
    assert nbytes == sum(t.numel() * t.element_size()
                         for t in (q, k, v)) + o_bytes
    lse_flops, lse_bytes = kernels.flash_attention_lse(
        shapes, _sizes(q, k, v), [causal, window, None, off])
    assert lse_flops == counted(lambda: ops.flash_attention_lse(
        q, k, v, causal, window, None, off))
    assert lse_bytes == nbytes + 4 * B * H * Sq


@pytest.mark.parametrize("case", ATTN)
def test_flash_attention_bwd_counts(case):
    B, Sq, Skv, H, KH, Dk, Dv, causal, window, off = case
    q, k, v = _attn_inputs(B, Sq, Skv, H, KH, Dk, Dv, F32)
    ops = torch.ops.repro_torch
    o, lse = ops.flash_attention_lse(q, k, v, causal, window, None, off)
    do = torch.randn_like(o)
    args = (q, k, v, o, do, lse)
    got = counted(lambda: ops.flash_attention_bwd(*args, causal, window,
                                                  None, off))
    flops, nbytes = kernels.flash_attention_bwd(
        [tuple(t.shape) for t in args], _sizes(*args),
        [causal, window, None, off])
    assert flops == got
    assert nbytes == (sum(t.numel() * 4 for t in args)
                      + sum(t.numel() * 4 for t in (q, k, v)))


SSD = [(1, 3, 8, 4, 16, 16, 1), (2, 2, 16, 6, 16, 8, 2)]


def _ssd_inputs(b, nc, Q, nh, hp, ds, G):
    g = torch.Generator().manual_seed(1)
    xdt = torch.randn(b, nc, Q, nh, hp, generator=g)
    B = torch.randn(b, nc, Q, G, ds, generator=g)
    C = torch.randn(b, nc, Q, G, ds, generator=g)
    cum = -torch.rand(b, nc, Q, nh, generator=g).cumsum(2)
    return xdt, B, C, cum


@pytest.mark.parametrize("case", SSD)
def test_ssd_chunk_counts(case):
    b, nc, Q, nh, hp, ds, G = case
    ins = _ssd_inputs(*case)
    ops = torch.ops.repro_torch
    got = counted(lambda: ops.ssd_chunk(*ins))
    flops, nbytes = kernels.ssd_chunk([tuple(t.shape) for t in ins],
                                      _sizes(*ins), [])
    assert flops == got
    y, states = ops.ssd_chunk(*ins)
    assert nbytes == sum(t.numel() * 4 for t in (*ins, y, states))
    dy, dst = torch.randn_like(y), torch.randn_like(states)
    args = (*ins, dy, dst)
    got = counted(lambda: ops.ssd_chunk_bwd(*args))
    flops, nbytes = kernels.ssd_chunk_bwd([tuple(t.shape) for t in args],
                                          _sizes(*args), [])
    assert flops == got
    assert nbytes == sum(t.numel() * 4 for t in (*args, *ins))


@pytest.mark.parametrize("sq, skv, causal, window, off", [
    (24, 24, True, 0, 0), (16, 48, True, 8, 32), (8, 8, False, 0, 0),
    (10, 10, True, 3, 0)])
def test_band_pairs_closed_form(sq, skv, causal, window, off):
    assert kernels._pairs_closed(sq, skv, causal, window, off) == \
        kernels.band_pairs(sq, skv, causal, window, off)


def test_model_count_equals_a_tiny_mla_prefill():
    """costs.model's forward of a prefill (the head at each prompt's last
    token) equals the operations FlopCounterMode counts in the port's
    prefill of the tiny MLA configuration: its products and K2's."""
    from perfbench.harness import program, weights

    cfg = json.loads((ROOT / "perfbench/configs/minicpm3-4b.json")
                     .read_text())
    cfg["model"].update(TINY["minicpm3-4b"], dtype="float32")
    net = program.load_model(cfg, weights.make(cfg, 3, "cpu"), "cpu")
    tokens = torch.randint(0, 256, (2, 20))
    got = counted(lambda: net.prefill({"tokens": tokens}))
    assert got == model.prefill_flops(cfg["model"], [20, 20])
