"""The POAS framework object — Predict → Optimize → Adapt → Schedule.

POAS itself is a *generic model*: it does not schedule applications directly
but produces a DS-POAS (domain-specific POAS) when bound to a domain's
predictor/optimizer/adapter/scheduler (paper §3, Fig. 1).  The binding point
is the ``Domain`` protocol (``core.domain``); ``POAS.plan`` runs the four
phases in order, each phase's output feeding the next, memoizing solved
plans in a ``PlanCache`` keyed on (workload geometry, device models).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Hashable, Sequence

from .adapt import GemmPlan, ops_to_mnk
from .bus import BusTopology
from .device_model import DeviceProfile, priority_order
from .domain import Domain, FunctionDomain, PlanCache, Workload, register_domain
from .optimize import OptimizeResult, solve_bisection
from .schedule import (Schedule, DynamicScheduler, make_spec,
                       simulate_timeline)


@dataclasses.dataclass(frozen=True)
class GemmWorkload:
    m: int
    n: int
    k: int

    def total_ops(self) -> float:
        return float(self.m) * self.n * self.k


@dataclasses.dataclass
class POASPlan:
    """Fully-adapted, schedulable plan (the DS-POAS output)."""
    workload: Any
    optimize: OptimizeResult
    adapted: Any          # domain-specific (GemmPlan for hgemms)
    schedule: Schedule


class POAS:
    """Generic four-phase pipeline over a bound ``Domain``.

    ``plan`` consults the ``PlanCache`` first: a hit skips the optimize
    solve (the expensive phase) entirely.  Pass ``cache=None`` to disable.
    """

    def __init__(self, domain: Domain, *, cache: PlanCache | None = None):
        self.domain = domain
        self.cache = cache
        # Dynamic domains re-fit models mid-run; hook cache invalidation so
        # a refit can never serve a plan solved under stale models.
        dyn = getattr(domain, "dyn", None)
        if cache is not None and isinstance(dyn, DynamicScheduler):
            dyn.add_refit_listener(cache.invalidate)

    @classmethod
    def from_callables(cls, *, predict: Callable[[], Sequence[DeviceProfile]],
                       optimize: Callable[..., OptimizeResult],
                       adapt: Callable[..., Any],
                       schedule: Callable[..., Schedule],
                       name: str = "custom") -> "POAS":
        """Legacy construction from four loose callables (uncached)."""
        return cls(FunctionDomain(name, predict, optimize, adapt, schedule))

    def plan(self, workload: Workload) -> POASPlan:
        devices = list(self.domain.predict())
        key: Hashable | None = None
        if self.cache is not None:
            key = self.cache.key(self.domain, devices, workload)
            hit = self.cache.get(key)
            if hit is not None:
                # shallow copy carrying the *caller's* workload; the solved
                # phases (optimize/adapted/schedule) are shared
                return dataclasses.replace(hit, workload=workload)
        opt = self.domain.optimize(devices, workload)
        adapted = self.domain.adapt(devices, opt, workload)
        sched = self.domain.schedule(devices, adapted, workload)
        plan = POASPlan(workload=workload, optimize=opt, adapted=adapted,
                        schedule=sched)
        if self.cache is not None and key is not None:
            # strip the workload before caching: for domains like serving
            # dispatch it holds the full request batch, which must not be
            # pinned for the cache's lifetime
            self.cache.put(key, dataclasses.replace(plan, workload=None))
        return plan


# ---------------------------------------------------------------------------
# The GEMM domain (paper §4 — hgemms builds on this)
# ---------------------------------------------------------------------------


@register_domain("gemm")
class GemmDomain:
    """The paper's DS-POAS for heterogeneous GEMM."""

    name = "gemm"

    def __init__(self, devices: Sequence[DeviceProfile], *,
                 bus: str | BusTopology = "serialized",
                 dynamic: bool = False):
        self._devices = list(devices)
        self.topology = BusTopology.from_spec(bus, self._devices)
        self.bus = self.topology.spec
        self.dyn = DynamicScheduler(self._devices, bus=self.topology) \
            if dynamic else None

    def predict(self) -> Sequence[DeviceProfile]:
        return self.dyn.snapshot() if self.dyn is not None else self._devices

    def optimize(self, devices: Sequence[DeviceProfile],
                 w: GemmWorkload) -> OptimizeResult:
        return solve_bisection(devices, w.total_ops(), n=w.n, k=w.k,
                               bus=self.topology)

    def adapt(self, devices: Sequence[DeviceProfile], opt: OptimizeResult,
              w: GemmWorkload) -> GemmPlan:
        return ops_to_mnk(devices, opt.ops, w.m, w.n, w.k)

    def schedule(self, devices: Sequence[DeviceProfile], plan: GemmPlan,
                 w: GemmWorkload) -> Schedule:
        ops = [float(a.m) * w.n * w.k for a in plan.assignments]
        # price the chunk counts adapt actually produced (alignment grain
        # can cap a device below its nominal pipeline_chunks)
        chunks = [max(1, len(a.chunk_rows)) for a in plan.assignments]
        tl = simulate_timeline(devices, ops, w.n, w.k,
                               topology=self.topology, chunks=chunks)
        finish = [tl.device_finish(d.name) for d in devices]
        res = OptimizeResult(ops=ops, makespan=tl.makespan,
                             finish_times=finish, bus=self.bus)
        return Schedule(result=res, timeline=tl,
                        priorities=priority_order(list(devices)),
                        spec=make_spec(devices, ops, w.n, w.k, self.topology,
                                       chunks))

    def cost_signature(self, w: GemmWorkload) -> Hashable:
        return (w.m, w.n, w.k)


def make_gemm_poas(devices: Sequence[DeviceProfile], *,
                   bus: str | BusTopology = "serialized",
                   dynamic: bool = False,
                   cache: bool = True) -> tuple[POAS, DynamicScheduler | None]:
    """Build the paper's DS-POAS for GEMM (hgemms uses this)."""
    domain = GemmDomain(devices, bus=bus, dynamic=dynamic)
    poas = POAS(domain, cache=PlanCache() if cache else None)
    return poas, domain.dyn
