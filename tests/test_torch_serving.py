"""The port's serving layer (``repro_torch.serving``) against the
reference's (``repro.serving``) on the CPU.

* ``ServingEngine.generate`` on tiny float32 models with the reference's
  weights (``params_from_reference``) gives the reference engine's greedy
  tokens, left padding included.
* ``PoasDispatcher`` plans are numpy and must be byte-identical: buckets,
  optimize shares, bucket tokens, predicted makespans and plan-cache
  counters are compared with ``==`` on the cases of ``tests/test_serving.py``
  and the continuous-batching cases of ``tests/test_runtime_streaming.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_tiny_config as ref_tiny_config
from repro.core.device_model import CopyModel as RefCopyModel
from repro.core.device_model import DeviceProfile as RefProfile
from repro.core.device_model import LinearTimeModel as RefLinear
from repro.core.device_model import NO_COPY as REF_NO_COPY
from repro.models import Model as RefModel
from repro.serving import engine as ref_engine
from repro_torch.configs import get_tiny_config
from repro_torch.core import list_domains
from repro_torch.core.device_model import (NO_COPY, CopyModel, DeviceProfile,
                                           LinearTimeModel)
from repro_torch.models.convert import params_from_reference
from repro_torch.serving import engine as port_engine

SRC = Path(__file__).resolve().parents[1] / "src"


def _engines(arch):
    cfg = ref_tiny_config(arch)
    ref = RefModel(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = params_from_reference(get_tiny_config(arch),
                                 jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    return (ref_engine.ServingEngine(ref, params),
            port_engine.ServingEngine(port), cfg)


@pytest.mark.parametrize("arch", ["hymba-1_5b", "stablelm-12b"])
def test_engine_gives_the_reference_greedy_tokens(arch):
    ref, port, cfg = _engines(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (40, 9, 23)]
    news = [5, 3, 5]
    want = ref.generate([ref_engine.Request(i, p, n)
                         for i, (p, n) in enumerate(zip(prompts, news))])
    got = port.generate([port_engine.Request(i, p, n)
                         for i, (p, n) in enumerate(zip(prompts, news))])
    assert [c.uid for c in got] == [c.uid for c in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
        assert g.prefill_s >= 0 and g.decode_s >= 0
    assert port.generate([]) == []


# ------------------------------------------------------------- dispatch ----

def _groups(pkg, copy=False):
    if pkg == "ref":
        P, L, C, N = RefProfile, RefLinear, RefCopyModel, REF_NO_COPY
    else:
        P, L, C, N = DeviceProfile, LinearTimeModel, CopyModel, NO_COPY
    first = C(1e6, dtype_size=4) if copy else N
    return [P("fast", "group", L(a=1e-6), first),
            P("slow", "group", L(a=3e-6), N)]


def _requests(pkg, spec):
    R = ref_engine.Request if pkg == "ref" else port_engine.Request
    return [R(uid=u, tokens=t, max_new_tokens=n) for u, t, n in spec]


def _spec(case):
    """(uid, prompt tokens, max_new_tokens) per request, from numpy."""
    if case == "balance":
        rng = np.random.default_rng(2)
        return [(i, rng.integers(1, 100, 16), 16) for i in range(40)]
    if case == "ragged":
        return [(i, np.arange(1 + i % 7), 2) for i in range(17)]
    if case == "mixed":
        rng = np.random.default_rng(3)
        return [(i, rng.integers(1, 60, int(rng.integers(4, 40))),
                 int(rng.integers(1, 32))) for i in range(50)]
    if case == "uniform":
        return [(i, np.arange(8), 4) for i in range(10)]
    raise KeyError(case)


def _plan_record(disp, buckets):
    plan = disp.last_plan
    return {
        "buckets": [[r.uid for r in b] for b in buckets],
        "shares": None if plan is None else list(plan.optimize.shares()),
        "ops": None if plan is None else list(plan.optimize.ops),
        "index_buckets": None if plan is None else plan.adapted.index_buckets,
        "bucket_tokens": None if plan is None else plan.adapted.bucket_tokens,
        "makespan": disp.predicted_makespan(buckets),
        "cache": dict(disp.poas.cache.stats()),
    }


def _run_split(pkg, case, n_groups=2, copy=False, repeat=1, fresh=False):
    disp = (ref_engine if pkg == "ref" else port_engine).PoasDispatcher(
        _groups(pkg, copy)[:n_groups])
    records = []
    for r in range(repeat):
        spec = _spec(case)
        if fresh:
            spec = [(u + 100 * r, t, n) for u, t, n in spec]
        buckets = disp.split(_requests(pkg, spec))
        records.append(_plan_record(disp, buckets))
    return records


@pytest.mark.parametrize("case,n_groups,copy,repeat,fresh", [
    ("balance", 2, False, 1, False),
    ("ragged", 2, False, 1, False),
    ("ragged", 1, False, 1, False),        # single group: degenerate split
    ("mixed", 2, False, 1, False),
    ("uniform", 2, False, 2, False),       # identical geometry: cache hit
    ("uniform", 2, False, 2, True),        # cache hit on fresh requests
    ("ragged", 2, True, 1, False),         # copy time in the makespan
])
def test_dispatch_plans_are_byte_identical(case, n_groups, copy, repeat,
                                           fresh):
    want = _run_split("ref", case, n_groups, copy, repeat, fresh)
    got = _run_split("port", case, n_groups, copy, repeat, fresh)
    assert got == want
    if repeat > 1:
        assert got[-1]["cache"]["hits"] == repeat - 1


def test_dispatch_empty_batch():
    disp = port_engine.PoasDispatcher(_groups("port"))
    assert disp.split([]) == [[], []]
    assert disp.last_plan is None
    assert "serving-dispatch" in list_domains()
    assert isinstance(disp.domain, port_engine.ServingDispatchDomain)


def _continuous(pkg):
    """admit -> dispatch_pending -> complete (4x slower, twice) -> re-fit ->
    admit -> dispatch_pending, recording every plan and the re-fit state."""
    disp = (ref_engine if pkg == "ref" else port_engine).PoasDispatcher(
        _groups(pkg), dynamic=True)
    spec = [(i, np.arange(24), 8) for i in range(30)]
    disp.admit(*_requests(pkg, spec))
    b1 = disp.dispatch_pending()
    out = [_plan_record(disp, b1)]
    for _ in range(2):
        tok = sum(len(r.tokens) + r.max_new_tokens for r in b1[0])
        disp.complete(0, b1[0], 4.0 * disp.groups[0].compute(tok))
    out.append({"epoch": disp.domain.dyn.epoch,
                "models": [(g.name, g.compute.a, g.compute.b)
                           for g in disp.domain.predict()]})
    disp.admit(*_requests(pkg, [(u + 200, t, n) for u, t, n in spec]))
    assert disp.pending == 30
    b2 = disp.dispatch_pending()
    out.append(_plan_record(disp, b2))
    assert disp.dispatch_pending() == [[], []]
    return out


def test_continuous_batching_refit_is_byte_identical():
    want = _continuous("ref")
    got = _continuous("port")
    assert got == want
    assert got[1]["epoch"] > 0
    assert got[2]["cache"]["invalidations"] > got[0]["cache"]["invalidations"]
    assert len(got[2]["buckets"][0]) < len(got[0]["buckets"][0])


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--tiny", "--device", "cpu", "--arch",
                           "hymba-1_5b", "--requests", "6", "--max-new", "3"],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "6 completions, 18 tokens" in proc.stdout
    assert "'hits': 1" in proc.stdout
