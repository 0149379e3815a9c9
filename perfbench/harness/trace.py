"""A traced segment under ``torch.profiler`` (the same work twice: once
tracing the device alone, once with the host's operations), reduced to
what the per-layer metrics read.

* ``ops``: each call of an operator that ``costs.kernels.OPS`` prices,
  with its input shapes, element sizes and scalar arguments and the device
  seconds of the kernels launched under it (by the enclosing operator,
  not by kernel name, so the reading follows the work whatever implements
  it);
* ``ranges``: device seconds under each ``record_function`` range, by name;
* ``busy_s``: the union of the intervals in which an operation ran on the
  device; ``window_s``: the host's wall time of the segment (both from the
  device-only pass, which slows the host least);
* ``device_ops``: the ten kernels that took the most device time;
* ``idle_gaps``: the device's idle time between operations, by the
  innermost host operation or range under way when it began, the ten
  largest.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict

import torch

from ..costs.kernels import OPS

_SIZES = {"float": 4, "float32": 4, "c10::BFloat16": 2, "bfloat16": 2,
          "c10::Half": 2, "half": 2, "double": 8, "long": 8, "int": 4}


@dataclasses.dataclass
class OpCall:
    name: str
    shapes: list
    sizes: list
    scalars: list
    device_s: float = 0.0


@dataclasses.dataclass
class Trace:
    ops: list
    ranges: dict
    busy_s: float
    window_s: float
    device_ops: list
    idle_gaps: list


def _call(e) -> OpCall | None:
    """An operator call from its event's shapes, dtypes and concrete
    inputs; None where they are not recorded."""
    shapes, dtypes = e.shapes(), e.dtypes()
    concrete = list(e.concrete_inputs() or [])
    if not shapes or len(dtypes) != len(shapes):
        return None
    concrete += [None] * (len(shapes) - len(concrete))
    tensors, sizes, scalars = [], [], []
    for shape, dt, val in zip(shapes, dtypes, concrete):
        if shape:
            tensors.append(tuple(shape))
            sizes.append(_SIZES.get(dt))
        else:
            scalars.append(val)
    if None in sizes:
        return None
    return OpCall(e.name(), tensors, sizes, scalars)


def _union(intervals: list) -> tuple[float, list]:
    """(length of the union, the merged intervals), in the trace's ns."""
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


class _Spans:
    """Host intervals of one thread, sorted, that hold no other of the
    same kind, to find the one under way at a time."""

    def __init__(self):
        self.by_thread: dict = defaultdict(list)

    def add(self, thread, start, end, item) -> None:
        self.by_thread[thread].append((start, end, item))

    def freeze(self) -> None:
        for spans in self.by_thread.values():
            spans.sort(key=lambda s: s[0])
        self.starts = {t: [s[0] for s in spans]
                       for t, spans in self.by_thread.items()}

    def at(self, thread, t):
        spans = self.by_thread.get(thread)
        if not spans:
            return None
        i = bisect.bisect_right(self.starts[thread], t) - 1
        if i >= 0 and spans[i][1] >= t:
            return spans[i][2]
        return None


def _kind(e) -> str:
    """The event's activity: "cpu_op", "user_annotation", "cuda_runtime",
    "kernel", "gpu_user_annotation", ... (by name where the profiler does
    not say)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    from torch.autograd import DeviceType
    if e.device_type() == DeviceType.CUDA:
        return "gpu_user_annotation" if e.is_user_annotation() else "kernel"
    if e.is_user_annotation():
        return "user_annotation"
    return "cuda_runtime" if e.name().startswith("cu") else "cpu_op"


def _device(events) -> list:
    """The device's operations: kernels, copies and sets, not the ranges'
    device-side copies."""
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type() == DeviceType.CUDA
            and _kind(e) != "gpu_user_annotation"]


def reduce_busy(prof, wall_s: float) -> tuple[float, list]:
    """(seconds in which an operation ran on the device, the ten kernels
    that took the most device time) of a trace."""
    dev = _device(prof.profiler.kineto_results.events())
    busy_ns, _ = _union([(e.start_ns(), e.end_ns()) for e in dev])
    by_kernel: dict = defaultdict(float)
    for e in dev:
        by_kernel[e.name()[:120]] += e.duration_ns() / 1e9
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return busy_ns / 1e9, [list(t) for t in top]


def reduce_ops(prof) -> tuple[list, dict, list]:
    """(the priced operators' calls with their device seconds, device
    seconds by range, the ten largest idle times by host activity) of a
    trace with host events.  A kernel belongs to the host operation the
    profiler links it to (the innermost under way at its launch) and to
    every priced operator and range that encloses that operation on its
    thread."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    spans = [e for e in host if _kind(e) in ("cpu_op", "user_annotation")]
    by_corr = {e.correlation_id(): e for e in spans}
    ops, ranges, calls = _Spans(), defaultdict(_Spans), []
    for e in spans:
        interval = (e.start_thread_id(), e.start_ns(), e.end_ns())
        if _kind(e) == "user_annotation":
            ranges[e.name()].add(*interval, e.name())
        elif e.name() in OPS:
            call = _call(e)
            if call is not None:
                calls.append(call)
                ops.add(*interval, call)
    ops.freeze()
    for r in ranges.values():
        r.freeze()
    range_s: dict = defaultdict(float)
    dev = _device(events)
    for k in dev:
        src = by_corr.get(k.linked_correlation_id())
        if src is None:
            continue
        at = (src.start_thread_id(), src.start_ns())
        d = k.duration_ns() / 1e9
        call = ops.at(*at)
        if call is not None:
            call.device_s += d
        for name, r in ranges.items():
            if r.at(*at) is not None:
                range_s[name] += d
    _, merged = _union([(e.start_ns(), e.end_ns()) for e in dev])
    gaps: dict = defaultdict(float)
    starts = [a for (_, a), _ in zip(merged, merged[1:])]
    for (_, a), (b, _), who in zip(merged, merged[1:],
                                   _host_at(host, starts)):
        gaps[who] += (b - a) / 1e9
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return calls, dict(range_s), [list(t) for t in idle]


def _host_at(host: list, times: list) -> list:
    """For each of the sorted ``times``, the innermost (shortest) host
    event under way then on any thread; events of one thread nest, so one
    sweep of a stack per thread finds them."""
    threads: dict = defaultdict(list)
    for e in host:
        threads[e.start_thread_id()].append((e.start_ns(), e.end_ns(),
                                             e.name()))
    best = [("host outside any operation", float("inf"))] * len(times)
    for spans in threads.values():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: list = []
        i = 0
        for j, t in enumerate(times):
            while i < len(spans) and spans[i][0] <= t:
                while stack and stack[-1][1] < spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            if stack and stack[-1][1] - stack[-1][0] < best[j][1]:
                best[j] = (stack[-1][2], stack[-1][1] - stack[-1][0])
    return [name for name, _ in best]


def traced(fn, device) -> Trace | None:
    """``fn()`` twice under the profiler, the device synchronised around
    each: first tracing the device alone, whose light touch on the host
    gives the busy and wall times and the top kernels; then with the host's
    operations and their shapes, for the operators' and ranges' device
    time and the idle gaps' host activity.  None off the card."""
    from torch.profiler import ProfilerActivity, profile

    if torch.device(device).type != "cuda":
        fn()
        fn()
        return None
    walls, profs = [], []
    for acts, shapes in (([ProfilerActivity.CUDA], False),
                         ([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                          True)):
        torch.cuda.synchronize()
        with profile(activities=acts, record_shapes=shapes) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        profs.append(prof)
    busy, top = reduce_busy(profs[0], walls[0])
    calls, ranges, idle = reduce_ops(profs[1])
    return Trace(ops=calls, ranges=ranges, busy_s=busy, window_s=walls[0],
                 device_ops=top, idle_gaps=idle)
