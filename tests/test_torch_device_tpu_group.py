"""The port's ``tpu_group`` and ``TPU_*`` planning constants
(``repro_torch.core``) are the reference's (``repro.core``), byte for byte:
the constants, the profile ``tpu_group`` returns at each argument, its JSON
save/load round trip through either package, and a plan made over such
profiles.  Profiles are compared as their dataclass fields with ``==``, as
``tests/test_torch_core_plan.py`` compares the other profiles.
"""
import dataclasses

import pytest

from repro import core as ref
from repro_torch import core as port

CONSTANTS = ["TPU_PEAK_FLOPS", "TPU_HBM_BW", "TPU_ICI_BW", "TPU_VMEM_BYTES"]
# (name, chips, keyword arguments): the defaults, tests/test_predict_profiles
# .py's derated group, and each keyword on its own.
GROUPS = [("pod", 1, {}), ("tpu", 8, {"derate": 0.9}),
          ("slice", 256, {"feed_bw": 25e9}),
          ("old", 64, {"derate": 0.5, "overhead_s": 1e-3}),
          ("odd", 3, {"derate": 0.7, "feed_bw": 1.5e9, "overhead_s": 0.0})]
IDS = [g[0] for g in GROUPS]


def _fields(x):
    return dataclasses.asdict(x)


@pytest.mark.parametrize("name", CONSTANTS)
def test_constants_equal(name):
    got, want = getattr(port, name), getattr(ref, name)
    assert type(got) is type(want) and got == want


def test_exported_as_the_reference_exports_them():
    for name in CONSTANTS + ["tpu_group"]:
        assert name in port.__all__
        assert name in ref.__all__


@pytest.mark.parametrize("name, chips, kw", GROUPS, ids=IDS)
def test_profile_equal(name, chips, kw):
    got, want = port.tpu_group(name, chips, **kw), ref.tpu_group(name, chips,
                                                                  **kw)
    assert _fields(got) == _fields(want)
    assert type(got.compute).__name__ == type(want.compute).__name__ \
        == "RooflineTimeModel"
    for ops in (0.0, 1.0, 3.7e12, 1e18):
        assert got.compute(ops) == want.compute(ops)
        assert got.copy(ops, 4096, 1024) == want.copy(ops, 4096, 1024)


@pytest.mark.parametrize("name, chips, kw", GROUPS, ids=IDS)
def test_profile_save_load_round_trip(tmp_path, name, chips, kw):
    """Port save -> port load gives the profile back; both packages write
    the same bytes, and each loads the other's file to equal fields."""
    pdev, rdev = port.tpu_group(name, chips, **kw), ref.tpu_group(name,
                                                                  chips, **kw)
    mine, theirs = tmp_path / "port.json", tmp_path / "ref.json"
    port.save_profiles(str(mine), [pdev])
    ref.save_profiles(str(theirs), [rdev])
    assert mine.read_bytes() == theirs.read_bytes()
    back = port.load_profiles(str(mine))
    assert back == [pdev]
    assert [_fields(d) for d in port.load_profiles(str(theirs))] == \
        [_fields(rdev)]
    assert [_fields(d) for d in ref.load_profiles(str(mine))] == \
        [_fields(rdev)]


@pytest.mark.parametrize("bus", ["serialized", "independent"])
def test_plan_over_groups_equal(bus):
    """A GEMM planned over two TPU groups beside the paper's mach1 devices
    is the reference's plan: shares, assignments and timeline events."""
    def devices(pkg):
        return pkg.paper_mach1() + [pkg.tpu_group("g0", 8),
                                    pkg.tpu_group("g1", 4, derate=0.8)]

    m, n, k = 30_000, 30_000, 30_000
    rp = ref.HGemms(devices(ref), bus=bus).plan(m, n, k)
    pp = port.HGemms(devices(port), device="cpu", bus=bus).plan(m, n, k)
    assert _fields(pp.optimize) == _fields(rp.optimize)
    assert _fields(pp.adapted) == _fields(rp.adapted)
    assert [dataclasses.astuple(e) for e in pp.schedule.timeline.events] == \
        [dataclasses.astuple(e) for e in rp.schedule.timeline.events]
