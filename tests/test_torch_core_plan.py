"""Planning in the port (``repro_torch.core``) is byte-identical to the JAX
package's (``repro.core``): every solver output, adapt-phase assignment and
timeline event is compared with ``==``, never approximately.

The cases are the paper's machines and inputs (``benchmarks/common.py``),
the small GEMM sizes of ``tests/test_core_poas.py`` and
``tests/test_bus_timeline.py``, both shared-bus models, and chunked
pipelined copies.
"""
import dataclasses

import numpy as np
import pytest

from repro import core as ref
from repro_torch import core as port

PAPER_INPUTS = {   # (m, n, k), benchmarks/common.py
    "i1": (30_000, 30_000, 30_000), "i2": (60_000, 20_000, 35_000),
    "i3": (130_000, 20_000, 20_000), "i4": (40_000, 80_000, 20_000),
    "i5": (40_000, 30_000, 60_000), "i6": (56_000, 40_000, 40_000),
}
SMALL_INPUTS = {   # (m, n, k)
    "hgemms-small": (256, 128, 96), "kernel-integration": (384, 256, 192),
    "subproducts": (4096, 1024, 2048), "concurrent": (2048, 1024, 512),
    "pipelined": (512, 256, 128), "alignment": (30001, 4096, 4096),
}
SIZES = {**PAPER_INPUTS, **SMALL_INPUTS}
MACHINES = ["paper_mach1", "paper_mach2"]


def _fields(x):
    """Field values of a dataclass tree, free of the defining class (the two
    packages define equal but distinct classes)."""
    return dataclasses.asdict(x)


def _events(timeline):
    return [dataclasses.astuple(e) for e in timeline.events]


def _assert_same_plan(rp, pp):
    assert _fields(pp.optimize) == _fields(rp.optimize)
    assert _fields(pp.adapted) == _fields(rp.adapted)
    assert _events(pp.schedule.timeline) == _events(rp.schedule.timeline)
    assert _fields(pp.schedule.result) == _fields(rp.schedule.result)
    assert pp.schedule.priorities == rp.schedule.priorities


def test_reference_profiles_are_equal():
    for name in MACHINES:
        assert [_fields(d) for d in getattr(port, name)()] == \
            [_fields(d) for d in getattr(ref, name)()]


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("bus", ["serialized", "independent"])
@pytest.mark.parametrize("chunks", [None, 4], ids=["unpipelined", "chunks4"])
def test_hgemms_plan_byte_identical(size, machine, bus, chunks):
    m, n, k = SIZES[size]
    rp = ref.HGemms(getattr(ref, machine)(), bus=bus,
                    pipeline_chunks=chunks).plan(m, n, k)
    pp = port.HGemms(getattr(port, machine)(), device="cpu", bus=bus,
                     pipeline_chunks=chunks).plan(m, n, k)
    _assert_same_plan(rp, pp)
    for a in pp.adapted.assignments:
        assert sum(a.chunk_rows) == a.m


@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("bus", ["serialized", "independent"])
def test_solvers_byte_identical(machine, bus):
    rdevs, pdevs = getattr(ref, machine)(), getattr(port, machine)()
    for m, n, k in SIZES.values():
        N = float(m) * n * k
        r = ref.solve_bisection(rdevs, N, n=n, k=k, bus=bus)
        assert _fields(port.solve_bisection(pdevs, N, n=n, k=k, bus=bus)) \
            == _fields(r)
        assert _fields(port.ops_to_mnk(pdevs, r.ops, m, n, k)) == \
            _fields(ref.ops_to_mnk(rdevs, r.ops, m, n, k))
        assert _events(port.simulate_timeline(pdevs, r.ops, n, k,
                                              topology=bus)) == \
            _events(ref.simulate_timeline(rdevs, r.ops, n, k, topology=bus))
    m, n, k = PAPER_INPUTS["i1"]
    N = float(m) * n * k
    assert _fields(port.solve_local_search(pdevs, N, n=n, k=k, bus=bus)) == \
        _fields(ref.solve_local_search(rdevs, N, n=n, k=k, bus=bus))


def _fitted_node(pkg):
    """A profile set like the one ``chip_smoke.py`` fits: a no-copy host
    CPU and a card on a copy model, with pipelining on the card."""
    return [pkg.DeviceProfile("host-cpu", "cpu",
                              pkg.LinearTimeModel(a=3.1e-12, b=2.5e-4),
                              pkg.NO_COPY, cache_bytes=32e6),
            pkg.DeviceProfile("h100", "gpu",
                              pkg.LinearTimeModel(a=7.3e-14, b=1.1e-4),
                              pkg.CopyModel(11.2e9, dtype_size=4,
                                            latency_s=1e-5),
                              align_m=128, pipeline_chunks=3)]


def test_profile_json_round_trip(tmp_path):
    """Profiles cross by the reference's own JSON: JAX save -> port load
    gives equal profiles and an identical plan, and both packages write the
    same bytes."""
    rdevs = ref.paper_mach1() + _fitted_node(ref)
    path = tmp_path / "ref.json"
    ref.save_profiles(str(path), rdevs)
    pdevs = port.load_profiles(str(path))
    assert [_fields(d) for d in pdevs] == [_fields(d) for d in rdevs]

    again = tmp_path / "port.json"
    port.save_profiles(str(again), pdevs)
    assert again.read_bytes() == path.read_bytes()
    assert [_fields(d) for d in ref.load_profiles(str(again))] == \
        [_fields(d) for d in rdevs]

    m, n, k = PAPER_INPUTS["i1"]
    _assert_same_plan(ref.HGemms(rdevs).plan(m, n, k),
                      port.HGemms(pdevs, device="cpu").plan(m, n, k))


def test_dynamic_scheduler_observe_refit_replan():
    """The same observations re-fit the same models and give the same
    re-plans, step by step."""
    n = k = 4000
    N = 1e13
    rdyn = ref.DynamicScheduler(ref.paper_mach2(), bus="serialized")
    pdyn = port.DynamicScheduler(port.paper_mach2(), bus="serialized")
    rng = np.random.default_rng(0)
    for step in range(6):
        rs, ps = rdyn.plan(N, n=n, k=k), pdyn.plan(N, n=n, k=k)
        assert _fields(ps.result) == _fields(rs.result)
        assert _events(ps.timeline) == _events(rs.timeline)
        for di, dev in enumerate(ref.paper_mach2()):
            ops = float(rng.uniform(1e11, 1e12))
            slow = 3.0 if (di == 2 and step >= 2) else 1.0
            secs = dev.compute(ops) * slow * (1 + 0.02 * rng.standard_normal())
            rdyn.observe(di, ops, secs)
            pdyn.observe(di, ops, secs)
        assert [_fields(d) for d in pdyn.snapshot()] == \
            [_fields(d) for d in rdyn.snapshot()]


def test_dynamic_hgemms_refit_invalidates_and_replans():
    rh = ref.HGemms(ref.paper_mach1(), dynamic=True)
    ph = port.HGemms(port.paper_mach1(), device="cpu", dynamic=True)
    m, n, k = SMALL_INPUTS["subproducts"]
    _assert_same_plan(rh.plan(m, n, k), ph.plan(m, n, k))
    for i in range(4):
        ops = 1e9 * (1 + i)
        secs = ref.paper_mach1()[1].compute(ops) * 2.5
        rh.dyn.observe(1, ops, secs)
        ph.dyn.observe(1, ops, secs)
    assert ph.plan_cache.stats() == rh.plan_cache.stats()
    _assert_same_plan(rh.plan(m, n, k), ph.plan(m, n, k))
