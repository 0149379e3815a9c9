"""First-class POAS domains — the paper's "generic model" made concrete.

POAS (§3, Fig. 1) is not a scheduler for one application: binding the four
phases — Predict, Optimize, Adapt, Schedule — to a domain's cost structure
produces a DS-POAS (domain-specific POAS).  This module defines that binding
point as a protocol, a process-wide registry of domain factories, and the
``PlanCache`` that memoizes solved plans across repeated ``plan()`` calls.

Four domains ship with this package:

* ``gemm``             — heterogeneous GEMM (``core.framework.GemmDomain``)
* ``serving-dispatch`` — request-batch dispatch across model replicas
                         (``serving.engine.ServingDispatchDomain``)
* ``train-step``       — heterogeneous data-parallel batch split
                         (``distributed.hetero.TrainStepDomain``)
* ``task-graph``       — precedence-constrained DAGs, list-scheduled
                         (``core.graph.TaskGraphDomain``)
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable, Protocol, Sequence, runtime_checkable

from .device_model import DeviceProfile
from .optimize import OptimizeResult
from .schedule import Schedule


@runtime_checkable
class Workload(Protocol):
    """Anything with a total op count; domains add their own geometry."""

    def total_ops(self) -> float: ...


@runtime_checkable
class Domain(Protocol):
    """The four POAS phases plus a cost signature for plan caching.

    ``predict``  returns the current device models (phase 1 — for dynamic
                 domains these are the re-fitted models);
    ``optimize`` splits the workload's ops across devices (phase 2);
    ``adapt``    maps op counts back to domain coordinates — GEMM rows,
                 request buckets, batch shards (phase 3);
    ``schedule`` produces the executable priority/bus timeline (phase 4);
    ``cost_signature`` is a hashable key of everything about the *workload*
                 that the solved plan depends on (device models are keyed
                 separately by the cache).

    Streaming conventions (DESIGN.md §9) — all shipped domains follow them:

    * a dynamic domain exposes its ``DynamicScheduler`` as ``self.dyn``
      (``None`` or absent = static).  ``POAS`` hooks the ``PlanCache``
      invalidation to its re-fits, and ``CoExecutionRuntime`` pumps
      measured timelines into it;
    * ``schedule`` fills ``Schedule.spec`` (a ``TimelineSpec``) so the
      runtime can rebase the plan onto carried-over clocks — or re-price
      it under ground-truth models — without knowing domain geometry.
    """

    name: str

    def predict(self) -> Sequence[DeviceProfile]: ...

    def optimize(self, devices: Sequence[DeviceProfile],
                 workload: Workload) -> OptimizeResult: ...

    def adapt(self, devices: Sequence[DeviceProfile], opt: OptimizeResult,
              workload: Workload) -> Any: ...

    def schedule(self, devices: Sequence[DeviceProfile], adapted: Any,
                 workload: Workload) -> Schedule: ...

    def cost_signature(self, workload: Workload) -> Hashable: ...


# ---------------------------------------------------------------------------
# Tenant policy (multi-tenant runtime, DESIGN.md §13)
# ---------------------------------------------------------------------------


TIER_LATENCY = 0
TIER_BATCH = 1


@dataclasses.dataclass(frozen=True)
class QoS:
    """What a tenant is *entitled to* — the domain-agnostic service policy
    the multi-tenant runtime schedules by (DESIGN.md §13).

    ``weight``      — weighted-fair share within a tier (2.0 = twice the
                      admission bandwidth of a weight-1.0 tenant);
    ``tier``        — strict priority class: every ``TIER_LATENCY`` job is
                      admitted before any eligible ``TIER_BATCH`` job, and
                      may preempt a batch job's not-yet-started frontier;
    ``deadline_s``  — default relative deadline per job (None = best
                      effort).  At admission the runtime prices the job's
                      predicted completion on the carried clocks via the
                      engine; an infeasible deadline is rejected before a
                      single ticket is issued.
    """

    weight: float = 1.0
    tier: int = TIER_BATCH
    deadline_s: float | None = None

    def __post_init__(self) -> None:
        if self.weight <= 0.0:
            raise ValueError(f"QoS weight must be > 0, got {self.weight}")
        if self.deadline_s is not None and self.deadline_s <= 0.0:
            raise ValueError("QoS deadline_s must be > 0 when set")


@dataclasses.dataclass
class FunctionDomain:
    """Adapter: four loose callables as a ``Domain`` (legacy construction)."""

    name: str
    predict_fn: Callable[[], Sequence[DeviceProfile]]
    optimize_fn: Callable[..., OptimizeResult]
    adapt_fn: Callable[..., Any]
    schedule_fn: Callable[..., Schedule]

    def predict(self) -> Sequence[DeviceProfile]:
        return self.predict_fn()

    def optimize(self, devices, workload):
        return self.optimize_fn(devices, workload)

    def adapt(self, devices, opt, workload):
        return self.adapt_fn(devices, opt, workload)

    def schedule(self, devices, adapted, workload):
        return self.schedule_fn(devices, adapted, workload)

    def cost_signature(self, workload) -> Hashable:
        # Loose callables carry no geometry contract: a fresh token per call
        # means a cache can never serve a stale plan (it just never hits).
        return (self.name, object())


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[..., Domain]] = {}


def register_domain(name: str) -> Callable[[Callable[..., Domain]],
                                           Callable[..., Domain]]:
    """Class decorator: ``@register_domain("gemm")`` above a Domain class."""

    def deco(factory: Callable[..., Domain]) -> Callable[..., Domain]:
        _REGISTRY[name] = factory
        return factory

    return deco


def get_domain(name: str, *args, **kwargs) -> Domain:
    """Instantiate a registered domain by name."""
    _ensure_builtin_domains()
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown POAS domain {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None
    return factory(*args, **kwargs)


def list_domains() -> list[str]:
    _ensure_builtin_domains()
    return sorted(_REGISTRY)


def _ensure_builtin_domains() -> None:
    """Import the modules that register the shipped domains (idempotent)."""
    from . import framework  # noqa: F401  (registers "gemm")
    from . import graph      # noqa: F401  (registers "task-graph")
    from ..serving import engine  # noqa: F401  ("serving-dispatch")
    from ..distributed import hetero  # noqa: F401  ("train-step")


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------


def device_signature(devices: Sequence[DeviceProfile]) -> Hashable:
    """Hashable fingerprint of the device *models* a plan was solved under.

    DeviceProfile and both time models are frozen dataclasses, so the tuple
    hashes by value: any model re-fit (DynamicScheduler) changes the key.
    """
    return tuple(devices)


class PlanCache:
    """LRU memo for solved POAS plans.

    Keyed on ``(domain name, workload cost signature, device-model
    signature)``: repeated ``plan()`` calls for the same geometry under the
    same predicted models skip the MILP/bisection solve entirely.  A
    ``DynamicScheduler`` re-fit changes the device signature *and* fires the
    registered invalidation hook, so stale entries can neither be served nor
    accumulate.

    Thread-safe: ``PoasDispatcher.split`` / ``HGemms.plan`` may be called
    concurrently from executor threads, and an ``OrderedDict`` being
    reordered by ``move_to_end`` while another thread iterates or pops is
    not — every access holds the lock (the critical sections are tiny
    relative to a solve, so contention is negligible).
    """

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self._entries: OrderedDict[Hashable, Any] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def key(self, domain: Domain, devices: Sequence[DeviceProfile],
            workload: Workload) -> Hashable:
        return (domain.name, domain.cost_signature(workload),
                device_signature(devices))

    def get(self, key: Hashable) -> Any | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry

    def put(self, key: Hashable, plan: Any) -> None:
        with self._lock:
            self._entries[key] = plan
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)

    def invalidate(self) -> None:
        """Drop every entry (called on model re-fits)."""
        with self._lock:
            if self._entries:
                self.invalidations += 1
            self._entries.clear()

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"size": len(self._entries), "hits": self.hits,
                    "misses": self.misses, "invalidations": self.invalidations}
