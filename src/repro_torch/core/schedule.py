"""POAS phase 4 — *Schedule*.

Static and dynamic schedulers plus the priority-ordered shared-bus
communication scheme (paper §3.4, §4.4, Fig. 2):

* input copies (A, B) run on the shared bus in priority order (fastest
  device first);
* each device computes as soon as its inputs land (overlapping other
  devices' copies);
* output copies (C) are serialized in the same priority order.

``simulate_timeline`` produces the exact event timeline under this policy —
it is a thin front over the unified bus engine (``core.bus``), the same
event graph the optimizer prices feasibility on and the overlapped executor
derives its per-link ticket order from (DESIGN.md §4).  ``DynamicScheduler``
re-fits the per-device linear model from observed step times (EWMA-weighted
regression) and re-plans — this is the paper's §3.4.2 dynamic mode and
doubles as the straggler mitigation of the distributed runtime.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

import numpy as np

from .bus import (BusEvent, BusTopology, ClockState, GraphTimelineSpec,
                  TaskSpec, Timeline, TimelineSpec, ZERO_CLOCKS,
                  build_graph_timeline, build_timeline)
from .device_model import DeviceProfile, LinearTimeModel, priority_order
from .optimize import OptimizeResult, solve_bisection
from .predict import fit_linear

__all__ = ["BusEvent", "Timeline", "TimelineSpec", "GraphTimelineSpec",
           "simulate_timeline", "simulate_graph_timeline",
           "Schedule", "StaticScheduler", "DynamicScheduler"]


# ---------------------------------------------------------------------------
# Timeline simulation (Fig. 2) — one engine, shared with solver and executor
# ---------------------------------------------------------------------------


def simulate_timeline(devices: Sequence[DeviceProfile], ops: Sequence[float],
                      n: int, k: int, *,
                      topology: BusTopology | str | None = None,
                      order: Sequence[int] | None = None,
                      chunks: Sequence[int] | None = None,
                      clocks: ClockState = ZERO_CLOCKS) -> Timeline:
    """Exact simulation of the Fig. 2 schedule on the unified bus engine.

    ``topology`` defaults to the paper's single serialized bus; pass a
    ``BusTopology`` for independent or mixed link layouts, ``order`` to
    override the priority order, ``chunks`` to override each device's
    ``pipeline_chunks``, and ``clocks`` to start from carried-over
    link/device clocks (streaming runtime, DESIGN.md §9)."""
    return build_timeline(devices, ops, n, k, topology=topology, order=order,
                          chunks=chunks, clocks=clocks)


def simulate_graph_timeline(devices: Sequence[DeviceProfile],
                            tasks: Sequence[TaskSpec],
                            edges: Sequence[tuple[int, int]],
                            assign: Sequence[int], *,
                            topology: BusTopology | str | None = None,
                            order: Sequence[int] | None = None,
                            clocks: ClockState = ZERO_CLOCKS) -> Timeline:
    """Exact simulation of a task-graph schedule on the unified bus engine
    (DESIGN.md §10): same clocks as the divisible Fig. 2 simulation, plus
    precedence — cross-device edges priced as host-staged link copies,
    same-device edges free."""
    return build_graph_timeline(devices, tasks, edges, assign,
                                topology=topology, order=order, clocks=clocks)


# ---------------------------------------------------------------------------
# Static scheduler (paper §3.4.1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Schedule:
    result: OptimizeResult
    timeline: Timeline
    priorities: list[int]  # device indices, highest priority first
    # Engine inputs the timeline was built from: lets a streaming runtime
    # rebase the plan onto carried-over clocks (or ground-truth models)
    # without knowing any domain geometry (DESIGN.md §9).  Divisible
    # domains attach a TimelineSpec, task-graph domains a GraphTimelineSpec
    # (DESIGN.md §10) — both expose rebase()/ops_by_device().
    spec: TimelineSpec | GraphTimelineSpec | None = None


def make_spec(devices: Sequence[DeviceProfile], ops: Sequence[float],
              n: int, k: int, topology: BusTopology | str | None,
              chunks: Sequence[int] | None = None) -> TimelineSpec:
    """The ``TimelineSpec`` for a schedule built with the default priority
    order (what every shipped domain does)."""
    devs = tuple(devices)
    return TimelineSpec(devices=devs, ops=tuple(float(c) for c in ops),
                        n=n, k=k,
                        topology=BusTopology.from_spec(topology, devs),
                        chunks=tuple(chunks) if chunks is not None else None,
                        order=tuple(priority_order(list(devs))))


class StaticScheduler:
    """Solve once, never re-plan (paper: 'gives excellent results' for GEMM)."""

    def __init__(self, devices: Sequence[DeviceProfile], *,
                 bus: str | BusTopology = "serialized"):
        self.devices = list(devices)
        self.bus = bus

    def plan(self, N: float, *, n: int, k: int) -> Schedule:
        res = solve_bisection(self.devices, N, n=n, k=k, bus=self.bus)
        tl = simulate_timeline(self.devices, res.ops, n, k, topology=self.bus)
        return Schedule(result=res, timeline=tl,
                        priorities=priority_order(self.devices),
                        spec=make_spec(self.devices, res.ops, n, k, self.bus))


# ---------------------------------------------------------------------------
# Dynamic scheduler (paper §3.4.2) — also the straggler mitigator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Obs:
    ops: float
    seconds: float
    weight: float


class DynamicScheduler:
    """Re-fits each device's linear model from observations and re-plans.

    Observations are weighted by an exponential decay (newest heaviest), so a
    device that starts throttling (the paper's overheating scenario / a
    straggling TPU pod) sees its model — and hence its share — adapt within a
    few steps.

    Thread-safe: the streaming runtime's observation pump delivers
    ``observe`` calls from completion threads while the planner thread reads
    the models through ``snapshot`` — a re-fit can land mid-plan without a
    torn read (the plan is solved against a coherent snapshot; the re-fit
    bumps ``epoch`` and invalidates the ``PlanCache``, so the very next plan
    sees the new models).
    """

    def __init__(self, devices: Sequence[DeviceProfile], *,
                 bus: str | BusTopology = "serialized", decay: float = 0.7,
                 window: int = 32, min_obs: int = 2,
                 reset_threshold: float = 0.5, min_change: float = 0.01):
        self.devices = list(devices)
        self.bus = bus
        self.decay = decay
        self.window = window
        self.min_obs = min_obs
        # Change-point detection: an observation deviating from the current
        # model by more than this relative threshold (e.g. a 2x thermal
        # throttle) drops the device's stale window before fitting —
        # otherwise pre-throttle points blend with post-throttle ones and
        # the regression can transiently fit a near-zero (or negative,
        # clamped) slope that mis-plans worse than never adapting.
        self.reset_threshold = reset_threshold
        # A re-fit whose predicted time at the observed size moves less
        # than this (relative) is treated as confirming the current model:
        # skip it, or a steady-state stream would invalidate the PlanCache
        # (and re-solve) on every observation.  The 1% default absorbs
        # exact confirmations and sub-percent drift; measurement noise
        # above it (wall-clock jitter on very short stages) still re-fits —
        # tracking what was really measured is the point of dynamic mode,
        # so raise min_change per-deployment if plan churn costs more than
        # model freshness.
        self.min_change = min_change
        self._obs: list[list[_Obs]] = [[] for _ in devices]
        self.epoch = 0  # bumped on every model re-fit
        self.window_resets = 0
        self._refit_listeners: list = []
        self._lock = threading.RLock()

    def add_refit_listener(self, fn) -> None:
        """``fn()`` is called after every model re-fit (PlanCache hooks in)."""
        self._refit_listeners.append(fn)

    def snapshot(self) -> list[DeviceProfile]:
        """A coherent copy of the current device models (planner threads
        must never iterate ``devices`` while an observe() re-fit lands)."""
        with self._lock:
            return list(self.devices)

    def set_devices(self, devices: Sequence[DeviceProfile]) -> None:
        """Elastic membership change-point (DESIGN.md §16): replace the
        device set.  Surviving devices (matched by name) keep their
        re-fitted models and observation windows; departed ones drop
        theirs; joiners start from their given profile.  Bumps ``epoch``
        and fires the re-fit listeners, so every ``PlanCache`` hooked to
        this scheduler invalidates and the next plan sees the new set."""
        with self._lock:
            fitted = {d.name: d for d in self.devices}
            obs = {d.name: o for d, o in zip(self.devices, self._obs)}
            self.devices = [fitted.get(d.name, d) for d in devices]
            self._obs = [obs.get(d.name, []) for d in devices]
            self.epoch += 1
        for fn in self._refit_listeners:
            fn()

    def _refit(self, device_index: int, model, at_ops: float) -> None:
        d = self.devices[device_index]
        old, new = d.compute(at_ops), model(at_ops)
        if old > 0.0 and abs(new - old) / old < self.min_change:
            return   # confirms the current model; don't churn the cache
        self.devices[device_index] = dataclasses.replace(d, compute=model)
        self.epoch += 1
        for fn in self._refit_listeners:
            fn()

    def observe(self, device_index: int, ops: float, seconds: float) -> None:
        with self._lock:
            buf = self._obs[device_index]
            pred = self.devices[device_index].compute(ops)
            if buf and pred > 0.0 and \
                    abs(seconds - pred) / pred > self.reset_threshold:
                buf.clear()   # regime change (throttle/recovery): the old
                self.window_resets += 1   # window would poison the fit
            for o in buf:
                o.weight *= self.decay
            buf.append(_Obs(ops=ops, seconds=seconds, weight=1.0))
            del buf[: max(0, len(buf) - self.window)]
            if len(buf) >= self.min_obs and len({o.ops for o in buf}) >= 2:
                model = fit_linear([o.ops for o in buf],
                                   [o.seconds for o in buf],
                                   weights=[o.weight for o in buf])
                self._refit(device_index, model, ops)
            elif buf:
                # single-size observations: rescale slope to match latest rate
                d = self.devices[device_index]
                latest = buf[-1]
                base = d.compute(latest.ops)
                if base > 0 and isinstance(d.compute, LinearTimeModel):
                    ratio = latest.seconds / base
                    m = LinearTimeModel(a=d.compute.a * ratio,
                                        b=d.compute.b * ratio)
                    self._refit(device_index, m, ops)

    def plan(self, N: float, *, n: int, k: int) -> Schedule:
        devices = self.snapshot()
        res = solve_bisection(devices, N, n=n, k=k, bus=self.bus)
        tl = simulate_timeline(devices, res.ops, n, k, topology=self.bus)
        return Schedule(result=res, timeline=tl,
                        priorities=priority_order(devices),
                        spec=make_spec(devices, res.ops, n, k, self.bus))

    def models(self) -> list[LinearTimeModel]:
        return [d.compute for d in self.snapshot()]
