"""``HGemms.execute`` in the port, run on the host (``device="cpu"``),
against the JAX package's ``HGemms.execute`` on the same numpy inputs: C
within the kernel's f32 tolerance, every report field that comes from the
device models exactly equal, and the measured timeline keeping the bus
invariants the reference's own tests hold (``tests/test_bus_timeline.py``).
"""
import numpy as np
import pytest
import torch

from repro import core as ref
from repro_torch import core as port
from repro_torch.kernels import matmul

RTOL, ATOL = 1e-4, 1e-3   # K1's f32 gate (tests/test_kernels_matmul.py)


def _pipelined(pkg):
    return pkg.with_pipeline(pkg.paper_mach1(), 4)


CASES = {   # name: (device set, m, k, n, bus)
    "mach1-small": (lambda pkg: pkg.paper_mach1(), 256, 96, 128,
                    "serialized"),
    "mach1-pipelined": (_pipelined, 512, 128, 256, "serialized"),
    "mach1-chunked": (_pipelined, 4096, 256, 512, "serialized"),
    "mach2-independent": (lambda pkg: pkg.paper_mach2(), 1024, 192, 320,
                          "independent"),
}


def _assert_bus_invariants(measured, planned):
    """Per-link transfers never overlap, each link grants in the plan's
    ticket order, and every compute (chunk) starts after its own input
    copy and ends before its output copy."""
    for link, seq in planned.link_ticket_order().items():
        evs = measured.link_events(link)
        for a, b in zip(evs, evs[1:]):
            assert b.start >= a.end - 1e-9, (a, b)
        got = []
        for e in sorted(evs, key=lambda e: e.start):
            if (e.device, e.kind) not in got:
                got.append((e.device, e.kind))
        assert got == seq
    for name in {e.device for e in measured.events}:
        evs = measured.device_events(name)
        by = {kind: sorted((e for e in evs if e.kind == kind),
                           key=lambda e: e.chunk)
              for kind in ("copy_in", "compute", "copy_out")}
        if by["copy_in"]:
            assert len(by["copy_in"]) == len(by["compute"])
            for i_ev, c_ev in zip(by["copy_in"], by["compute"]):
                assert c_ev.start >= i_ev.end - 1e-9
        for c_ev, o_ev in zip(by["compute"], by["copy_out"]):
            assert o_ev.start >= c_ev.end - 1e-9


@pytest.mark.parametrize("case", list(CASES))
def test_execute_matches_reference(case):
    devs, m, k, n, bus = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)

    rc, rrep = ref.HGemms(devs(ref), bus=bus).execute(a, b)
    before = matmul.launches
    hg = port.HGemms(devs(port), device="cpu", bus=bus)
    pc, prep = hg.execute(a, b)
    assert matmul.launches == before   # CPU tensors never launch the kernel

    assert pc.dtype == rc.dtype and pc.shape == rc.shape
    np.testing.assert_allclose(pc, rc, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pc, a.astype(np.float64) @ b, rtol=RTOL,
                               atol=ATOL)
    assert prep.predicted_makespan == rrep.predicted_makespan
    assert prep.simulated_makespan == rrep.simulated_makespan
    assert prep.standalone == rrep.standalone
    assert prep.per_device_seconds == rrep.per_device_seconds
    assert prep.speedups == rrep.speedups
    assert [tuple(vars(e).values()) for e in prep.timeline.events] == \
        [tuple(vars(e).values()) for e in rrep.timeline.events]
    _assert_bus_invariants(prep.measured, prep.plan.schedule.timeline)


def test_chunked_device_streams_its_chunks():
    """The chunked case really pipelines on the port: the xpu's A slice
    arrives in several chunks, each computed after it landed."""
    devs, m, k, n, bus = CASES["mach1-chunked"]
    rng = np.random.default_rng(7)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c, rep = port.HGemms(devs(port), device="cpu", bus=bus).execute(a, b)
    ins = [e for e in rep.measured.device_events("2080ti-tensor")
           if e.kind == "copy_in"]
    assert len(ins) == 4
    np.testing.assert_allclose(c, a.astype(np.float64) @ b, rtol=RTOL,
                               atol=ATOL)


def test_noisy_dynamic_execute_matches_reference():
    """Noised model times and the dynamic re-fit they feed are the same
    numpy arithmetic in both packages."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((640, 64)).astype(np.float32)
    b = rng.standard_normal((64, 96)).astype(np.float32)
    rh = ref.HGemms(ref.paper_mach2(), dynamic=True)
    ph = port.HGemms(port.paper_mach2(), device="cpu", dynamic=True)
    for seed in range(3):
        _, rrep = rh.execute(a, b, noise=0.05, seed=seed)
        pc, prep = ph.execute(a, b, noise=0.05, seed=seed)
        assert prep.per_device_seconds == rrep.per_device_seconds
        assert prep.simulated_makespan == rrep.simulated_makespan
        np.testing.assert_allclose(pc, a @ b, rtol=RTOL, atol=ATOL)
    assert [(x.a, x.b) for x in ph.dyn.models()] == \
        [(x.a, x.b) for x in rh.dyn.models()]


def test_prediction_errors_match_reference():
    m = n = k = 30_000
    assert port.HGemms(port.paper_mach2(), device="cpu").prediction_errors(
        m, n, k, noise=0.03) == \
        ref.HGemms(ref.paper_mach2()).prediction_errors(m, n, k, noise=0.03)


def test_cpu_partition_uses_host_matmul_and_card_lanes_stay_on_host():
    """On ``device="cpu"`` no lane holds a CUDA stream; the ``cpu`` profile
    computes with ``torch.matmul``, the others with the kernel wrapper."""
    hg = port.HGemms(port.paper_mach1(), device="cpu")
    lanes = [hg.lanes[d.name] for d in hg.devices]
    assert all(lane.copy_stream is None and lane.compute_stream is None
               for lane in lanes)
    assert all(lane.target == torch.device("cpu") for lane in lanes)
    assert [lane.mm is torch.matmul for lane in lanes] == [True, False, False]
    assert lanes[1].mm is matmul
