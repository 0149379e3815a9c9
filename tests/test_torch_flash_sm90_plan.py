"""K2's sm90 plan on the CPU: the K/V tile and ring depth each head dim
takes, that the launch fits a block's shared memory, that the route rules
stay as they were, and that the wrapper hands the plan to the kernel's
entry.

The kernel itself runs only on the card (``chip_smoke.py`` holds it against
the plain version there); here the wrapper's CUDA branch is driven with a
stand-in library that records what its entry was called with.
"""
import contextlib
import importlib
import types

import pytest
import torch

from repro_torch.kernels import _nvcc, flash_attention, flash_attention_bwd

fa = importlib.import_module("repro_torch.kernels.flash_attention")

# (Dk, Dv) of the zoo and of the tests: hymba 64, dbrx / qwen2 / llama4 /
# deepseek 128, stablelm 160, minicpm3's MLA 96 / 64, the tests' 32 and 256.
HEAD_DIMS = [(32, 32), (64, 64), (96, 64), (128, 128), (160, 160),
             (256, 256)]


@pytest.mark.parametrize("dk,dv", HEAD_DIMS, ids=lambda d: str(d))
def test_plan_fits_shared_memory(dk, dv):
    plan = fa.sm90_plan(dk, dv)
    assert plan.smem <= _nvcc.SMEM_LIMIT == 232_448
    assert 2 <= plan.stages <= 4


def test_every_sm90_head_dim_fits():
    """Every (Dk, Dv) the route sends to sm90 has a plan the entry takes:
    64 keys, or 128 where Dv is at most 128; 2-4 stages; in 232,448 B."""
    for dk in range(16, 257, 16):
        for dv in range(16, 257, 16):
            plan = fa.sm90_plan(dk, dv)
            assert plan.keys == 64 or (plan.keys == 128 and dv <= 128)
            assert 2 <= plan.stages <= 4, (dk, dv, plan)
            assert plan.smem <= _nvcc.SMEM_LIMIT, (dk, dv, plan)


@pytest.mark.parametrize("dk,dv,want", [
    (32, 32, fa.Sm90Plan(128, 4, 148_736)),
    (64, 64, fa.Sm90Plan(128, 4, 148_736)),
    (96, 64, fa.Sm90Plan(128, 4, 230_656)),
    (128, 128, fa.Sm90Plan(128, 3, 230_656)),
    (160, 160, fa.Sm90Plan(64, 3, 197_888)),
    (256, 256, fa.Sm90Plan(64, 2, 197_888)),
    (192, 128, fa.Sm90Plan(64, 4, 214_272))])
def test_plan_by_head_dims(dk, dv, want):
    """128 keys a tile where both head dims are at most 128, else 64; as
    many ring stages (up to 4) as fit beside Q's 128 rows."""
    assert fa.sm90_plan(dk, dv) == want


def test_routes_are_unchanged():
    """float32 -> tf32x3; bf16 at multiples of 16 up to 256 -> sm90, else
    simt; the backward's rule is the forward's."""
    for dk in range(1, 257):
        for dv in (1, 16, 40, 64, 96, 128, 160, 256):
            want = "sm90" if dk % 16 == 0 and dv % 16 == 0 else "simt"
            assert fa.route(torch.bfloat16, dk, dv) == want
            assert fa.route(torch.float32, dk, dv) == "tf32x3"
            for dt in (torch.bfloat16, torch.float32):
                assert fa.route_bwd(dt, dk, dv) == fa.route(dt, dk, dv)


def test_reset_counts_zeroes_the_sm90_counts():
    flash_attention.launches_sm90 += 3
    flash_attention.launches += 3
    flash_attention_bwd.launches_sm90 += 1
    fa.reset_counts()
    assert (flash_attention.launches, flash_attention.launches_sm90,
            flash_attention_bwd.launches_sm90) == (0, 0, 0)


class _Library:
    """A stand-in for every K2 library: each entry records its name and
    arguments and returns 0 (no CUDA error)."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        return lambda *a: self.calls.append((name, a)) or 0


@pytest.fixture
def stand_in(monkeypatch):
    """The kernel libraries replaced by entries that record their calls,
    and the CUDA device and stream calls by no-ops, so that ``_launch`` and
    ``_launch_bwd`` run their CUDA branches on CPU tensors."""
    calls = []
    lib = _Library(calls)
    monkeypatch.setattr(_nvcc, "load", lambda src, entries: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    fa.reset_counts()
    yield calls
    fa.reset_counts()


@pytest.mark.parametrize("dk,dv", HEAD_DIMS, ids=lambda d: str(d))
@pytest.mark.parametrize("with_lse", [False, True])
def test_launch_passes_the_plan(stand_in, dk, dv, with_lse):
    """The entry gets the plan's keys and stages first, then the tensors
    and shapes; the launch is counted on sm90."""
    q = torch.zeros(1, 8, 2, dk, dtype=torch.bfloat16)
    v = torch.zeros(1, 8, 2, dv, dtype=torch.bfloat16)
    o, lse = fa._launch("sm90", q, q, v, True, 0, None, with_lse)
    plan = fa.sm90_plan(dk, dv)
    ((name, call),) = stand_in
    assert name == "poas_flash_sm90_bf16"
    assert call[:2] == (plan.keys, plan.stages)
    assert call[2:5] == (q.data_ptr(), q.data_ptr(), v.data_ptr())
    assert call[5] == o.data_ptr()
    assert call[6] == (lse.data_ptr() if with_lse else 0)
    assert call[7:14] == (1, 8, 8, 2, 2, dk, dv)
    assert (flash_attention.launches, flash_attention.launches_sm90) == (1, 1)


@pytest.mark.parametrize("kind,dtype,entry", [
    ("tf32x3", torch.float32, "poas_flash_tf32x3_f32"),
    ("simt", torch.bfloat16, "poas_flash_bf16")])
def test_other_forward_routes_get_no_plan(stand_in, kind, dtype, entry):
    """Only the sm90 entry takes keys and stages: the other forward
    entries get the tensors first."""
    q = torch.zeros(1, 8, 2, 64, dtype=dtype)
    o, _ = fa._launch(kind, q, q, q, True, 0, None, False)
    ((name, call),) = stand_in
    assert name == entry
    assert call[:4] == (q.data_ptr(), q.data_ptr(), q.data_ptr(),
                        o.data_ptr())
    assert getattr(flash_attention, f"launches_{kind}") == 1


@pytest.mark.parametrize("kind,dtype,entry", [
    ("sm90", torch.bfloat16, "poas_flash_bwd_sm90_bf16"),
    ("tf32x3", torch.float32, "poas_flash_bwd_tf32x3_f32"),
    ("simt", torch.bfloat16, "poas_flash_bwd_bf16")])
def test_backward_entries_get_the_tensors_first(stand_in, kind, dtype,
                                                entry):
    """The backward's entries take no plan: q, k, v, o, dO, lse, dq, dk, dv
    and the scratch come first, then the shapes; the launch is counted on
    its route."""
    q = torch.zeros(1, 8, 2, 64, dtype=dtype)
    lse = torch.zeros(1, 2, 8)
    fa._launch_bwd(kind, q, q, q, q, q, lse, True, 0, None)
    ((name, call),) = stand_in
    assert name == entry
    assert call[:3] == (q.data_ptr(),) * 3
    assert call[10:17] == (1, 8, 8, 2, 2, 64, 64)
    assert (flash_attention_bwd.launches,
            getattr(flash_attention_bwd, f"launches_{kind}")) == (1, 1)


def test_aligned16_copies_rows_repeated_by_stride_zero():
    """The sm90 kernel's tensor maps are given nonzero strides only: a view
    that repeats rows with stride 0 is copied; a stride-0 dimension of
    extent 1 is not."""
    base = torch.arange(8 * 64, dtype=torch.float32).bfloat16()
    wide = base.view(1, 8, 1, 64).expand(1, 8, 3, 64)
    fixed = fa._aligned16(wide)
    assert fixed is not wide and fixed.stride(2) != 0
    assert torch.equal(fixed, wide)
    one = base.view(1, 8, 64)[:, :, None, :].expand(1, 8, 1, 64)
    assert fa._aligned16(one) is one
