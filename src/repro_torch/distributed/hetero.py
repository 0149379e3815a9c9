"""POAS-driven heterogeneous data parallelism — the paper's scheduler as the
framework's batch partitioner (DESIGN.md §3.2).

Pods (or pod-slices) are POAS "devices": per-pod throughput is predicted by
a linear model over tokens (``ops`` ≙ tokens × FLOPs/token), the min-makespan
solver splits the global batch, and the Adapt phase rounds each share to the
pod's shard grain (data_shards × microbatch) via the core grain-rounding
primitive.  All four phases are bound as the registered ``train-step``
domain; ``HeteroBatchScheduler`` is a facade over it.  The Dynamic scheduler
re-fits from measured step times — which invalidates the plan cache — so a
straggling pod automatically sheds load: straggler mitigation without
preemption.
"""
from __future__ import annotations

import dataclasses
from typing import Hashable, Mapping, Sequence

import numpy as np

from ..core.adapt import round_shares_to_grain
from ..core.bus import BusTopology, Timeline
from ..core.device_model import (DeviceProfile, LinearTimeModel, NO_COPY,
                                 priority_order)
from ..core.domain import PlanCache, register_domain
from ..core.framework import POAS
from ..core.optimize import OptimizeResult, solve_bisection
from ..core.runtime import ObservationPump
from ..core.schedule import (DynamicScheduler, Schedule, make_spec,
                             simulate_timeline)


@dataclasses.dataclass(frozen=True)
class PodProfile:
    name: str
    chips: int
    peak_flops: float           # per chip
    derate: float = 1.0         # thermal / generation derate
    grain: int = 1              # batch rows must be a multiple (data shards)


def pod_device(p: PodProfile, flops_per_token: float) -> DeviceProfile:
    """A pod as a POAS device; 'ops' are tokens."""
    tok_per_s = p.chips * p.peak_flops * p.derate * 0.4 / flops_per_token
    return DeviceProfile(
        p.name, "tpu-group",
        LinearTimeModel(a=1.0 / tok_per_s, b=2e-3),
        NO_COPY, align_m=p.grain)


@dataclasses.dataclass(frozen=True)
class TrainStepWorkload:
    """One data-parallel training step; ops are tokens."""

    global_batch: int
    seq_len: int

    def total_ops(self) -> float:
        return float(self.global_batch * self.seq_len)


@dataclasses.dataclass(frozen=True)
class BatchSplit:
    """Frozen: instances are shared via the PlanCache, so caller mutation
    would corrupt every future cache hit."""

    sizes: tuple[int, ...]     # per-pod batch rows (sum == global batch)
    predicted_step_s: float

    def __post_init__(self):
        object.__setattr__(self, "sizes", tuple(self.sizes))

    def offsets(self) -> list[int]:
        out, acc = [], 0
        for s in self.sizes:
            out.append(acc)
            acc += s
        return out


@register_domain("train-step")
class TrainStepDomain:
    """DS-POAS for the heterogeneous data-parallel training step."""

    name = "train-step"

    def __init__(self, pods: Sequence[PodProfile], *, flops_per_token: float,
                 seq_len: int, dynamic: bool = True):
        self.pods = list(pods)
        self.seq_len = seq_len
        self.flops_per_token = flops_per_token
        self._devices = [pod_device(p, flops_per_token) for p in self.pods]
        # pods feed through their own interconnects, not a shared host bus:
        # each gets an independent link in the topology (no contention)
        self.topology = BusTopology.independent(self._devices)
        self.dyn = DynamicScheduler(self._devices, bus=self.topology) \
            if dynamic else None

    def predict(self) -> Sequence[DeviceProfile]:
        return self.dyn.snapshot() if self.dyn is not None else self._devices

    def set_pods(self, pods: Sequence[PodProfile]) -> None:
        """Elastic membership change-point (DESIGN.md §16): replace the
        pod set.  Dynamic mode carries re-fitted models for surviving
        pods (matched by name) and invalidates hooked plan caches."""
        self.pods = list(pods)
        self._devices = [pod_device(p, self.flops_per_token)
                         for p in self.pods]
        self.topology = BusTopology.independent(self._devices)
        if self.dyn is not None:
            self.dyn.bus = self.topology
            self.dyn.set_devices(self._devices)

    def set_devices(self, devices: Sequence[DeviceProfile], *,
                    topology=None) -> None:
        """Runtime-facing membership hook (``CoExecutionRuntime.device_
        leave/join``): the given profiles are authoritative; pod rows are
        matched by name, and a joiner announced as a raw ``DeviceProfile``
        gets a derived pod row (grain from its row alignment)."""
        by_name = {p.name: p for p in self.pods}
        self.pods = [by_name.get(d.name,
                                 PodProfile(d.name, chips=1, peak_flops=0.0,
                                            grain=max(1, d.align_m)))
                     for d in devices]
        self._devices = list(devices)
        self.topology = BusTopology.independent(self._devices)
        if self.dyn is not None:
            self.dyn.bus = self.topology
            self.dyn.set_devices(self._devices)

    def optimize(self, devices: Sequence[DeviceProfile],
                 w: TrainStepWorkload) -> OptimizeResult:
        return solve_bisection(devices, w.total_ops(), n=1, k=1,
                               bus=self.topology)

    def adapt(self, devices: Sequence[DeviceProfile], opt: OptimizeResult,
              w: TrainStepWorkload) -> BatchSplit:
        # tokens -> batch rows, rounded to each pod's grain
        raw = [c / self.seq_len for c in opt.ops]
        sizes = round_shares_to_grain(
            raw, [p.grain for p in self.pods], w.global_batch)
        pred = max((d.compute(s * self.seq_len)
                    for d, s in zip(devices, sizes) if s > 0), default=0.0)
        return BatchSplit(sizes=sizes, predicted_step_s=pred)

    def schedule(self, devices: Sequence[DeviceProfile], split: BatchSplit,
                 w: TrainStepWorkload) -> Schedule:
        ops = [float(s * self.seq_len) for s in split.sizes]
        tl = simulate_timeline(devices, ops, 1, 1, topology=self.topology)
        res = OptimizeResult(ops=ops, makespan=tl.makespan,
                             finish_times=[tl.device_finish(d.name)
                                           for d in devices],
                             bus="independent")
        return Schedule(result=res, timeline=tl,
                        priorities=priority_order(list(devices)),
                        spec=make_spec(devices, ops, 1, 1, self.topology))

    def cost_signature(self, w: TrainStepWorkload) -> Hashable:
        return (w.global_batch, w.seq_len)


class HeteroBatchScheduler:
    """Static or dynamic POAS split of the global batch across pods.

    Facade over the registered ``train-step`` domain; repeated ``plan``
    calls for the same global batch are served from the ``PlanCache`` until
    a measured observation re-fits a pod model.
    """

    def __init__(self, pods: Sequence[PodProfile], *, flops_per_token: float,
                 seq_len: int, dynamic: bool = True, cache: bool = True):
        self.pods = list(pods)
        self.seq_len = seq_len
        self.flops_per_token = flops_per_token
        self.domain = TrainStepDomain(pods, flops_per_token=flops_per_token,
                                      seq_len=seq_len, dynamic=dynamic)
        self.poas = POAS(self.domain, cache=PlanCache() if cache else None)
        # the one feedback path (DESIGN.md §9): measured step times flow
        # through the same ObservationPump the streaming runtime uses
        self.pump: ObservationPump | None = None
        if self.domain.dyn is not None:
            self.pump = ObservationPump(self.domain.dyn,
                                        [p.name for p in self.pods])

    @property
    def dyn(self) -> DynamicScheduler | None:
        return self.domain.dyn

    @property
    def devices(self) -> list[DeviceProfile]:
        return list(self.domain.predict())

    @property
    def plan_cache(self) -> PlanCache | None:
        return self.poas.cache

    def plan(self, global_batch: int) -> BatchSplit:
        w = TrainStepWorkload(global_batch=global_batch, seq_len=self.seq_len)
        return self.poas.plan(w).adapted

    def observe(self, pod_index: int, batch_rows: int, seconds: float):
        """Feed a measured per-pod step time (dynamic mode)."""
        if self.pump is None:
            return
        self.pump.observe(self.pods[pod_index].name,
                          float(batch_rows * self.seq_len), seconds)

    def feed_step(self, split: BatchSplit,
                  measured: "Timeline | Mapping[str, float]") -> int:
        """Feed one training step's measurements through the pump.

        ``measured`` is either a measured ``Timeline`` (per-pod compute
        events, e.g. from the streaming runtime) or a plain mapping of pod
        name -> step seconds.  Returns the number of observations fed.
        """
        if self.pump is None:
            return 0
        ops = {p.name: float(s * self.seq_len)
               for p, s in zip(self.pods, split.sizes) if s > 0}
        if isinstance(measured, Timeline):
            return self.pump.feed(measured, ops)
        fed = 0
        for name, seconds in measured.items():
            if ops.get(name, 0.0) > 0.0:
                self.pump.observe(name, ops[name], float(seconds))
                fed += 1
        return fed

    def pod_leave(self, name: str) -> None:
        """Pod departure as a membership change-point: shrink the split
        domain (surviving pods keep their re-fitted models), drop the
        plan cache, re-key the pump — the next ``plan`` solves on the
        smaller cluster."""
        pods = [p for p in self.pods if p.name != name]
        if len(pods) == len(self.pods):
            return
        if not pods:
            raise ValueError(f"pod {name!r} is the last pod; cannot leave")
        self.pods = pods
        self.domain.set_pods(pods)
        if self.poas.cache is not None:
            self.poas.cache.invalidate()
        if self.pump is not None:
            self.pump.index = {p.name: i for i, p in enumerate(pods)}

    def pod_join(self, pod: PodProfile) -> None:
        """Pod arrival: widen the split domain at the next ``plan``."""
        if any(p.name == pod.name for p in self.pods):
            return
        pods = self.pods + [pod]
        self.pods = pods
        self.domain.set_pods(pods)
        if self.poas.cache is not None:
            self.poas.cache.invalidate()
        if self.pump is not None:
            self.pump.index = {p.name: i for i, p in enumerate(pods)}

    def imbalance(self, split: BatchSplit) -> float:
        """Predicted idle fraction of the fastest-finishing pod."""
        devices = self.domain.predict()
        times = [d.compute(s * self.seq_len)
                 for d, s in zip(devices, split.sizes) if s > 0]
        if not times:
            return 0.0
        return 1.0 - min(times) / max(times)
