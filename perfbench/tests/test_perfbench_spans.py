"""The per-layer metrics that read the port's spans (``forward_ms.train``,
``decode_device_ms_per_step.serve``) on traces built by hand, through the lines
that build a ``Trace`` from a profile; and the program's new spans moving
none of the other readings: the same trace with and without them gives the
same operators, busy time, ranges of the older names and readings."""
from __future__ import annotations

import itertools
import json
import types

import pytest
from conftest import ROOT
from torch.autograd import DeviceType

from perfbench.harness import trace
from perfbench.harness.registry import Registry

MS = 1_000_000          # the trace's ns in a millisecond
MAIN, AUTOGRAD = 1, 2   # the step's thread and the autograd engine's
# the spans the program adds, which the parent's program lacks
NEW = {"model.decode_step", "train_step.forward", "train_step.backward"}
OLD_READERS = {"serve": ["mfu.prefill", "decode_ms_per_step.serve",
                         "k2_roofline.prefill", "idle_share.serve"],
               "train": ["mfu.train", "optimizer_ms.train",
                         "k3_bwd_roofline.train", "idle_share.train"]}


class Event:
    """The part of a ``torch.profiler`` kineto event the harness reads."""

    def __init__(self, kind, name, start, end, thread=MAIN, corr=0,
                 linked=0, shapes=(), dtypes=(), concrete=()):
        self.kind, self._name = kind, name
        self._start, self._end = int(start * MS), int(end * MS)
        self._thread, self._corr, self._linked = thread, corr, linked
        self._shapes, self._dtypes = list(shapes), list(dtypes)
        self._concrete = list(concrete)

    def device_type(self):
        return (DeviceType.CUDA if self.kind in ("kernel",
                                                 "gpu_user_annotation")
                else DeviceType.CPU)

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def duration_ns(self):
        return self._end - self._start

    def start_thread_id(self):
        return self._thread

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def shapes(self):
        return self._shapes

    def dtypes(self):
        return self._dtypes

    def concrete_inputs(self):
        return self._concrete


class Profile:
    def __init__(self, events):
        results = types.SimpleNamespace(events=lambda: events)
        self.profiler = types.SimpleNamespace(kineto_results=results)


class Builder:
    def __init__(self):
        self.events, self._ids = [], itertools.count(1)

    def range(self, name, start, end, thread=MAIN):
        self.events.append(Event("user_annotation", name, start, end,
                                 thread, next(self._ids)))
        # the range's own row on the device, which the harness leaves out
        self.events.append(Event("gpu_user_annotation", name, start, end))

    def op(self, name, start, end, kernel, thread=MAIN, **args):
        corr = next(self._ids)
        self.events.append(Event("cpu_op", name, start, end, thread, corr,
                                 **args))
        self.events.append(Event("kernel", f"k.{name}", *kernel,
                                 linked=corr))


def _trace(b: Builder, wall_s: float, keep_new: bool) -> trace.Trace:
    """A ``Trace`` by ``trace.traced``'s own lines, from one profile for
    both passes; without ``keep_new`` the program's new spans are left
    out, as the parent's program records none."""
    events = [e for e in b.events if keep_new or e.name() not in NEW]
    prof = Profile(events)
    busy, top = trace.reduce_busy(prof, wall_s)
    calls, ranges, idle = trace.reduce_ops(prof)
    return trace.Trace(ops=calls, ranges=ranges, busy_s=busy,
                       window_s=wall_s, device_ops=top, idle_gaps=idle)


def _serve():
    """A batch: a prefill (K2 and a product), the argmax, two decode steps
    of one product each; then the cell's window of one batch of 3 tokens
    a request, whose two decode steps the engine clocked at 40 ms."""
    b = Builder()
    b.op("repro_torch::flash_attention", 2, 3, (4, 30),
         shapes=[[1, 8, 2, 16]] * 3 + [[]] * 4,
         dtypes=["c10::BFloat16"] * 3 + ["Scalar"] * 4,
         concrete=[None] * 3 + [True, 0, 0.25, 0])
    b.op("aten::mm", 5, 6, (30, 38))
    b.op("aten::argmax", 40.2, 40.4, (40.5, 40.6))
    b.range("model.decode_step", 41, 60)
    b.op("aten::mm", 42, 43, (45, 50))
    b.range("model.decode_step", 61, 80)
    b.op("aten::mm", 62, 63, (65, 72))
    b.op("aten::copy_", 81, 82, (83, 84))
    prompts = [types.SimpleNamespace(tokens=[0] * n) for n in (6, 8)]
    done = [types.SimpleNamespace(tokens=[1, 2, 3], decode_s=0.04,
                                  prefill_s=0.039) for _ in prompts]
    run = types.SimpleNamespace(batches=[types.SimpleNamespace(
        prompts=prompts, completions=done)])
    return b, 0.1, run, {"new_tokens": 3}


def _train():
    """A step: the forward's two layers on the step's thread; the backward
    on the autograd engine's, remat's recompute of one layer in it, then
    K3-bwd; the optimizer's two updates on the step's thread, their device
    intervals overlapping."""
    b = Builder()
    b.range("train_step.forward", 1, 40)
    b.range("transformer.layer", 2, 20)
    b.op("aten::mm", 3, 4, (5, 9))
    b.range("transformer.layer", 21, 39)
    b.op("aten::add", 22, 23, (24, 30))
    b.range("train_step.backward", 41, 80)
    b.range("transformer.layer", 45, 60, thread=AUTOGRAD)
    b.op("aten::mm", 46, 47, (48, 55), thread=AUTOGRAD)
    b.op("repro_torch::ssd_chunk_bwd", 61, 62, (63, 75), thread=AUTOGRAD,
         shapes=[[1, 2, 4, 2, 4], [1, 2, 4, 1, 8], [1, 2, 4, 1, 8],
                 [1, 2, 4, 2], [1, 2, 4, 2, 4], [1, 2, 4, 2, 4]],
         dtypes=["float"] * 6, concrete=[None] * 6)
    b.range("train_step.optimizer", 81, 99)
    b.op("aten::add", 82, 83, (84, 95))
    b.op("aten::mul", 85, 86, (94, 97))
    run = types.SimpleNamespace(traced_steps=1, window_steps=3, t0=0.0,
                                t_end=6.0)
    return b, 0.1, run, {"batch": 4, "seq_len": 2048}


CELLS = {"serve": ("minicpm3-4b.serve-longdoc", _serve),
         "train": ("mamba2-2_7b.train-4x2048", _train)}


def _ctx(kind, t, run, mix):
    reg = Registry(ROOT)
    workload, _ = CELLS[kind]
    cell = reg.workload(workload)
    mix = dict(reg.traffic(cell["traffic"]), **mix)
    peaks = json.loads((reg.bench / "costs" / "peaks.json").read_text())
    return types.SimpleNamespace(workload=cell,
                                 config=reg.config(cell["config"]), mix=mix,
                                 run=run, trace=t, peaks=peaks)


def _read(name, ctx):
    return Registry(ROOT).reader(name)(ctx)


def test_forward_ms_reads_the_forward_span_on_its_thread():
    b, wall, run, mix = _train()
    t = _trace(b, wall, keep_new=True)
    # 4 + 6 ms of the forward's kernels; the backward's, launched from the
    # autograd engine's thread, are no range's of the step's thread
    assert _read("forward_ms.train", _ctx("train", t, run, mix)) == \
        pytest.approx(10.0)
    run.traced_steps = 2
    assert _read("forward_ms.train", _ctx("train", t, run, mix)) == \
        pytest.approx(5.0)
    assert "train_step.backward" not in t.ranges
    assert t.ranges["transformer.layer"] == pytest.approx((4 + 6 + 7) / 1e3)


def test_decode_device_ms_reads_the_decode_spans_of_the_traced_batch():
    b, wall, run, mix = _serve()
    t = _trace(b, wall, keep_new=True)
    # 5 + 7 ms of device time over the traced batch's 2 steps; the
    # prefill's kernels and the argmax between the steps are no step's
    assert t.ranges["model.decode_step"] == pytest.approx(0.012)
    name = "decode_device_ms_per_step.serve"
    assert _read(name, _ctx("serve", t, run, mix)) == pytest.approx(6.0)
    # a span with no device work adds nothing to the device time
    b.range("model.decode_step", 85, 90)
    t = _trace(b, wall, keep_new=True)
    assert _read(name, _ctx("serve", t, run, mix)) == pytest.approx(6.0)
    # a kernel of the step still running after the span closed is the
    # step's: it belongs to the span its launch fell in
    b.range("model.decode_step", 91, 93)
    b.op("aten::mm", 92, 92.5, (94, 98))
    t = _trace(b, wall, keep_new=True)
    assert _read(name, _ctx("serve", t, run, mix)) == pytest.approx(8.0)


@pytest.mark.parametrize("kind, name", [
    ("serve", "decode_device_ms_per_step.serve"),
    ("train", "forward_ms.train")])
def test_a_span_reader_gives_none_without_the_span_or_a_trace(kind, name):
    _, build = CELLS[kind]
    b, wall, run, mix = build()
    assert _read(name, _ctx(kind, None, run, mix)) is None
    parent = _trace(b, wall, keep_new=False)
    assert _read(name, _ctx(kind, parent, run, mix)) is None


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_the_new_spans_move_no_other_reading(kind):
    """The same trace with and without the program's new spans: operators,
    busy time, top kernels and the older ranges are equal, so are the
    readings of the metrics there before; the idle time is the same in
    sum, only some of it now named after a span."""
    _, build = CELLS[kind]
    b, wall, run, mix = build()
    new, old = (_trace(b, wall, keep_new=k) for k in (True, False))
    assert new.ops == old.ops and new.ops
    assert new.busy_s == old.busy_s and new.device_ops == old.device_ops
    assert {k: v for k, v in new.ranges.items() if k not in NEW} == \
        old.ranges
    assert sum(s for _, s in new.idle_gaps) == \
        pytest.approx(sum(s for _, s in old.idle_gaps))
    for name in OLD_READERS[kind]:
        got, want = (_read(name, _ctx(kind, t, run, mix))
                     for t in (new, old))
        assert got == want and got is not None, name
