"""The train-step domain of the port (``repro_torch.distributed.hetero``:
``PodProfile``, ``TrainStepDomain``, ``HeteroBatchScheduler``) is
byte-identical to the JAX package's, and the port's
``FaultTolerantRunner.remesh`` routes pod departures and arrivals through
the scheduler as the reference's does.

Each case builds the same pods in both packages, drives the same calls and
compares every batch split, predicted step time, schedule timeline, plan
cache count and re-fit epoch with ``==``, never approximately.  The cases
are ``tests/test_cluster_membership.py``'s hetero train-step round trip
(its lines 237-340), the straggler loop of
``examples/straggler_mitigation.py`` and a virtual-time stream of training
steps through each package's ``CoExecutionRuntime``.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import pytest
import torch
from test_torch_graph_domain import canon

ROOTS = ("repro", "repro_torch")
SEQ = 4096
FLOPS = 6 * 12e9


def _pkg(root):
    return (importlib.import_module(f"{root}.core"),
            importlib.import_module(f"{root}.distributed.hetero"))


def same(case):
    """Run ``case(core, hetero)`` in both packages; the canonical results
    must be equal.  Returns the port's."""
    want, got = (canon(case(*_pkg(root))) for root in ROOTS)
    assert got == want
    return got


def _pods(h, name):
    return {
        # tests/test_cluster_membership.py
        "two": [h.PodProfile("pod0", chips=256, peak_flops=197e12, grain=16),
                h.PodProfile("pod1", chips=128, peak_flops=197e12,
                             grain=16)],
        "three-derated": [
            h.PodProfile("a", chips=256, peak_flops=197e12, grain=8),
            h.PodProfile("b", chips=256, peak_flops=197e12, derate=0.6,
                         grain=8),
            h.PodProfile("c", chips=64, peak_flops=459e12, grain=4)],
        "uneven-grains": [
            h.PodProfile("p0", chips=32, peak_flops=197e12, grain=1),
            h.PodProfile("p1", chips=96, peak_flops=197e12, grain=12),
            h.PodProfile("p2", chips=16, peak_flops=918e12, derate=0.8,
                         grain=2)],
    }[name]


POD_SETS = ["two", "three-derated", "uneven-grains"]


@pytest.mark.parametrize("pods", POD_SETS)
@pytest.mark.parametrize("batch", [48, 384, 1000])
@pytest.mark.parametrize("dynamic", [False, True])
def test_train_step_domain_round_trip(pods, batch, dynamic):
    """Predict, optimize, adapt and schedule of the registered
    ``train-step`` domain, and its cost signature."""
    def case(c, h):
        dom = h.TrainStepDomain(_pods(h, pods), flops_per_token=FLOPS,
                                seq_len=SEQ, dynamic=dynamic)
        w = h.TrainStepWorkload(global_batch=batch, seq_len=SEQ)
        devices = list(dom.predict())
        opt = dom.optimize(devices, w)
        split = dom.adapt(devices, opt, w)
        return (devices, opt, split, split.offsets(),
                dom.schedule(devices, split, w), dom.cost_signature(w),
                [h.pod_device(p, FLOPS) for p in _pods(h, pods)])
    same(case)


@pytest.mark.parametrize("pods", POD_SETS)
def test_poas_plan_and_cache(pods):
    """The domain through ``POAS`` and the registry: the plan, and plan
    cache hits for a repeated global batch."""
    def case(c, h):
        s = h.HeteroBatchScheduler(_pods(h, pods), flops_per_token=FLOPS,
                                   seq_len=SEQ, dynamic=True)
        plans = [s.plan(b) for b in (256, 256, 512, 256)]
        via_registry = c.get_domain(
            "train-step", _pods(h, pods), flops_per_token=FLOPS,
            seq_len=SEQ, dynamic=False)
        w = h.TrainStepWorkload(global_batch=256, seq_len=SEQ)
        return (plans, s.plan_cache.stats(), s.devices,
                [s.imbalance(p) for p in plans],
                c.POAS(via_registry).plan(w))
    same(case)


@pytest.mark.parametrize("pods", POD_SETS)
def test_feed_step_refits_and_sheds_load(pods):
    """Measured step times by pod name and as a ``Timeline``: the pump's
    observations, the re-fit epochs and every later split
    (``test_feed_step_routes_measurements_by_pod_name``)."""
    def case(c, h):
        s = h.HeteroBatchScheduler(_pods(h, pods), flops_per_token=FLOPS,
                                   seq_len=SEQ, dynamic=True)
        split = s.plan(384)
        out = [split]
        base = {p.name: d.compute(r * SEQ)
                for p, d, r in zip(s.pods, s.devices, split.sizes)}
        slow = s.pods[-1].name
        for step in range(3):
            fed = s.feed_step(split, {
                name: (3.0 * t * (1 + 0.01 * step) if name == slow else t)
                for name, t in base.items()})
            out.append((fed, s.dyn.epoch, s.plan(384)))
        first = s.pods[0].name
        tl = c.Timeline([c.BusEvent(device=first, kind="compute", start=0.0,
                                    end=base[first])])
        out.append((s.feed_step(split, tl), s.feed_step(split,
                                                        {"ghost": 1.0})))
        s.observe(0, split.sizes[0], 2.0 * base[first])
        out.append((s.pump.observations, s.dyn.epoch, s.plan(384),
                    s.plan_cache.stats(), s.devices))
        return out
    same(case)


def test_straggler_loop():
    """``examples/straggler_mitigation.py``: pod1 drops to 40 % at step
    10; the dynamic split follows it, step by step."""
    def case(c, h):
        pods = [h.PodProfile("pod0", 256, 197e12, grain=16),
                h.PodProfile("pod1", 256, 197e12, grain=16)]
        s = h.HeteroBatchScheduler(pods, flops_per_token=FLOPS, seq_len=SEQ,
                                   dynamic=True)
        out = []
        for step in range(30):
            split = s.plan(256)
            times = [rows * SEQ * FLOPS / (256 * 197e12 * 0.4 * (
                0.4 if i == 1 and step >= 10 else 1.0)) + 2e-3
                for i, rows in enumerate(split.sizes)]
            s.feed_step(split, {p.name: t for p, t in zip(pods, times)})
            out.append((split, s.dyn.epoch))
        return out
    last_split = dict(same(case)[-1][0][1:])
    assert last_split["sizes"][1] < 128          # pod1 shed load


@pytest.mark.parametrize("dynamic", [False, True])
def test_pod_leave_and_join(dynamic):
    """Membership change-points: every split after each departure and
    arrival, the re-keyed pump, the carried models."""
    def case(c, h):
        pods = _pods(h, "three-derated")
        s = h.HeteroBatchScheduler(pods, flops_per_token=FLOPS, seq_len=SEQ,
                                   dynamic=dynamic)
        out = [s.plan(384)]
        if dynamic:
            s.feed_step(out[0], {"b": 0.9, "c": 0.2})
        s.pod_leave("b")
        out.append((s.pods, s.plan(384), s.devices))
        s.pod_leave("b")                       # a second leave is a no-op
        s.pod_join(pods[1])
        out.append((s.pods, s.plan(384), s.devices))
        s.pod_join(pods[1])                    # already a member
        s.pod_leave("a")
        out.append((s.pods, s.plan(384), s.plan_cache.stats()))
        if dynamic:
            out.append(s.feed_step(out[-1][1], {"b": 0.5, "c": 0.5}))
        s.pod_leave("b")
        with pytest.raises(ValueError):
            s.pod_leave("c")
        return out
    same(case)


def test_runtime_membership_hook():
    """``set_devices``, the runtime-facing hook: pod rows matched by name,
    a joiner announced as a raw ``DeviceProfile`` gets a derived pod."""
    def case(c, h):
        pods = _pods(h, "two")
        dom = h.TrainStepDomain(pods, flops_per_token=FLOPS, seq_len=SEQ)
        extra = c.DeviceProfile("pod9", "tpu-group",
                                c.LinearTimeModel(a=1e-7, b=2e-3), c.NO_COPY,
                                align_m=8)
        dom.set_devices([dom.predict()[1], extra])
        w = h.TrainStepWorkload(global_batch=384, seq_len=SEQ)
        devices = list(dom.predict())
        opt = dom.optimize(devices, w)
        return dom.pods, devices, opt, dom.adapt(devices, opt, w)
    same(case)


def test_virtual_stream_of_training_steps():
    """Training steps as a stream through ``CoExecutionRuntime`` (virtual
    time), one pod throttled from the third step, feedback on: every
    job's plan and timelines and the runtime's stats."""
    def case(c, h):
        pods = _pods(h, "two")
        dom = h.TrainStepDomain(pods, flops_per_token=FLOPS, seq_len=SEQ)
        truth = c.truth_from_profiles(
            list(dom.predict()),
            lambda uid, name: 2.5 if uid >= 2 and name == "pod1" else 1.0)
        w = h.TrainStepWorkload(global_batch=384, seq_len=SEQ)
        with c.CoExecutionRuntime(dom, executor="virtual", truth=truth,
                                  feedback=True, max_inflight=1) as rt:
            jobs = rt.run_stream([w] * 6)
            return ([(j.uid, j.plan, j.planned, j.measured, j.epoch_at_plan)
                     for j in jobs], rt.stats(),
                    c.verify_stream_invariants(jobs))
    same(case)


def _reference_runner(tmp_path):
    from repro.distributed.elastic import FaultTolerantRunner, RunnerConfig
    runner = FaultTolerantRunner(
        RunnerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2),
        step_fn=lambda state, batch: ({"x": state["x"] + 1.0}, {}),
        state={"x": jnp.asarray(0.0)})
    runner.run(({} for _ in range(4)), num_steps=4)
    return runner


def _port_runner(tmp_path):
    from repro_torch.distributed.elastic import (FaultTolerantRunner,
                                                 RunnerConfig)
    runner = FaultTolerantRunner(
        RunnerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2),
        step_fn=lambda state, batch: ({"x": state["x"] + 1.0}, {}),
        state={"x": torch.zeros(())})
    runner.run(({} for _ in range(4)), num_steps=4)
    return runner


def test_remesh_routes_membership_through_scheduler(tmp_path):
    """``remesh(device, scheduler=, lost=, joined=)``: the port checkpoints,
    routes the pods through ``pod_leave`` / ``pod_join``, re-homes and
    restores at the same step; the scheduler's next splits equal those
    after the reference's ``remesh`` (test_cluster_membership.py)."""
    splits = {}
    for root, make, device in (("repro", _reference_runner, None),
                               ("repro_torch", _port_runner, "cpu")):
        _, h = _pkg(root)
        runner = make(tmp_path / root)
        s = h.HeteroBatchScheduler(_pods(h, "two"), flops_per_token=FLOPS,
                                   seq_len=SEQ)
        before = s.plan(384)
        runner.remesh(device, scheduler=s, lost=("pod1",))
        assert [p.name for p in s.pods] == ["pod0"]
        assert runner.step == 4
        alone = s.plan(384)
        runner.remesh(device, scheduler=s, joined=(_pods(h, "two")[1],))
        assert [p.name for p in s.pods] == ["pod0", "pod1"]
        splits[root] = canon((before, alone, s.plan(384),
                              s.plan_cache.stats()))
        assert float(runner.state["x"]) == 4.0
    assert splits["repro_torch"] == splits["repro"]
    assert splits["repro_torch"][1][1] == ("sizes", (384,))


def test_remesh_without_a_scheduler_only_rehomes(tmp_path):
    runner = _port_runner(tmp_path)
    leaf = runner.state["x"]
    runner.remesh("cpu")
    assert runner.state["x"] is leaf and float(leaf) == 4.0
    assert runner.step == 4


def test_domains_are_the_reference_domains():
    ref, port = (importlib.import_module(f"{r}.core") for r in ROOTS)
    assert port.list_domains() == ref.list_domains() == [
        "gemm", "serving-dispatch", "task-graph", "train-step"]
    _, h = _pkg("repro_torch")
    assert isinstance(port.get_domain(
        "train-step", _pods(h, "two"), flops_per_token=FLOPS, seq_len=SEQ),
        h.TrainStepDomain)
