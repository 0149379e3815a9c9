"""Batched serving engine with POAS request dispatch.

``ServingEngine`` runs prefill + decode for batches of requests on one model
replica, eagerly under ``torch.inference_mode`` on the model's device: the
prefill goes through the hand-written kernels (K2 attention, K3 SSD chunks),
the decode steps through plain torch.  ``PoasDispatcher`` splits an
incoming request batch across device groups (model replicas with differing
throughput) through the registered ``serving-dispatch`` POAS domain:
predicted prefill+decode time per group (linear in tokens), min-makespan
split (core optimizer), largest-first bucket packing (core adapt
primitive) — the serving analogue of hgemms (DESIGN.md §3.3).  The domain,
the dispatcher and their plans are numpy, byte-identical to the
reference's.

Continuous batching (DESIGN.md §9): with ``dynamic=True`` the dispatcher
keeps an admission queue — requests arriving while a batch is in flight are
``admit``-ed and picked up by the next ``dispatch_pending`` — and routes
per-bucket measured generation times through the shared ``ObservationPump``
back into the group models, so the split adapts to replicas that slow down
(and the ``PlanCache`` is invalidated on every re-fit, never serving a
stale packing).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Hashable, Sequence

import numpy as np
import torch

from ..core.adapt import pack_largest_first
from ..core.bus import BusTopology
from ..core.device_model import DeviceProfile, priority_order
from ..core.domain import PlanCache, register_domain
from ..core.framework import POAS, POASPlan
from ..core.optimize import OptimizeResult, solve_bisection
from ..core.runtime import ObservationPump
from ..core.schedule import (DynamicScheduler, Schedule, make_spec,
                             simulate_timeline)
from ..models import Model


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray          # (prompt_len,)
    max_new_tokens: int = 16


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: np.ndarray
    prefill_s: float
    decode_s: float


class ServingEngine:
    """One replica: batched greedy decode with a shared-length KV cache."""

    def __init__(self, model: Model):
        self.model = model

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def generate(self, requests: Sequence[Request]) -> list[Completion]:
        if not requests:
            return []
        plen = max(len(r.tokens) for r in requests)
        max_new = max(r.max_new_tokens for r in requests)
        B = len(requests)
        prompts = np.zeros((B, plen), np.int64)
        for i, r in enumerate(requests):   # left-pad with token 0
            prompts[i, plen - len(r.tokens):] = r.tokens

        model = self.model
        with torch.inference_mode():
            t0 = time.perf_counter()
            tokens = torch.from_numpy(prompts).to(model.device)
            logits, cache = model.prefill({"tokens": tokens})
            cache = model.extend_cache(cache, max_new)
            self._sync()
            t_prefill = time.perf_counter() - t0

            outs = [logits.argmax(-1)]
            t0 = time.perf_counter()
            for _ in range(max_new - 1):
                logits, cache = model.decode_step(
                    cache, {"tokens": outs[-1][:, None]})
                outs.append(logits.argmax(-1))
            self._sync()
            t_decode = time.perf_counter() - t0
            gen = torch.stack(outs, dim=1).cpu().numpy()

        return [Completion(r.uid, gen[i, :r.max_new_tokens],
                           t_prefill, t_decode)
                for i, r in enumerate(requests)]


@dataclasses.dataclass(frozen=True)
class RequestBatch:
    """A request batch as a POAS workload; ops = tokens to process
    (prompt + generated) per request."""

    requests: tuple[Request, ...]

    def token_counts(self) -> list[int]:
        return [len(r.tokens) + r.max_new_tokens for r in self.requests]

    def total_ops(self) -> float:
        return float(sum(self.token_counts()))


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """Adapt-phase output: request *indices* per serving group.

    Indices (not request objects) make the plan reusable from the
    ``PlanCache``: any batch with the same ordered token geometry gets the
    same packing applied to its own requests.  Frozen (tuple fields) because
    instances are shared across cache hits.
    """

    index_buckets: tuple[tuple[int, ...], ...]
    bucket_tokens: tuple[float, ...]

    def __post_init__(self):
        object.__setattr__(self, "index_buckets",
                           tuple(tuple(b) for b in self.index_buckets))
        object.__setattr__(self, "bucket_tokens", tuple(self.bucket_tokens))

    def assign(self, requests: Sequence[Request]) -> list[list[Request]]:
        return [[requests[i] for i in bucket] for bucket in self.index_buckets]


@register_domain("serving-dispatch")
class ServingDispatchDomain:
    """DS-POAS for request dispatch across heterogeneous model replicas.

    Optimize is the core min-makespan solver over token counts; Adapt is the
    core largest-first packer (op shares -> request buckets); Schedule is the
    standard priority timeline over bucket token totals.
    """

    name = "serving-dispatch"

    def __init__(self, groups: Sequence[DeviceProfile], *,
                 dynamic: bool = False):
        self._groups = list(groups)
        # replica groups don't share a host bus: one private link each
        self.topology = BusTopology.independent(self._groups)
        self.dyn = DynamicScheduler(self._groups, bus=self.topology) \
            if dynamic else None

    def predict(self) -> Sequence[DeviceProfile]:
        return self.dyn.snapshot() if self.dyn is not None else self._groups

    def optimize(self, groups: Sequence[DeviceProfile],
                 batch: RequestBatch) -> OptimizeResult:
        return solve_bisection(groups, batch.total_ops(), n=1, k=1,
                               bus=self.topology)

    def adapt(self, groups: Sequence[DeviceProfile], opt: OptimizeResult,
              batch: RequestBatch) -> DispatchPlan:
        tok = batch.token_counts()
        packed = pack_largest_first(tok, opt.ops)
        return DispatchPlan(
            index_buckets=packed,
            bucket_tokens=[float(sum(tok[i] for i in b)) for b in packed])

    def schedule(self, groups: Sequence[DeviceProfile], plan: DispatchPlan,
                 batch: RequestBatch) -> Schedule:
        ops = plan.bucket_tokens
        tl = simulate_timeline(groups, ops, 1, 1, topology=self.topology)
        res = OptimizeResult(ops=ops, makespan=tl.makespan,
                             finish_times=[tl.device_finish(g.name)
                                           for g in groups],
                             bus="independent")
        return Schedule(result=res, timeline=tl,
                        priorities=priority_order(list(groups)),
                        spec=make_spec(groups, ops, 1, 1, self.topology))

    def cost_signature(self, batch: RequestBatch) -> Hashable:
        return tuple(batch.token_counts())


class PoasDispatcher:
    """Split a request batch across heterogeneous serving groups.

    A thin facade over the registered ``serving-dispatch`` domain: repeated
    batches with identical token geometry hit the ``PlanCache`` and skip the
    solve.

    Continuous-batching mode (``dynamic=True``): requests arriving while a
    batch is in flight are ``admit``-ed into a pending queue and picked up
    by the next ``dispatch_pending``; per-bucket measured generation times
    fed to ``complete`` flow through the shared ``ObservationPump`` into the
    group models (re-fit → ``PlanCache`` invalidation → the next dispatch is
    re-planned under the refreshed throughputs).
    """

    def __init__(self, groups: Sequence[DeviceProfile], *, grain: int = 1,
                 cache: bool = True, dynamic: bool = False):
        self.groups = list(groups)
        self.grain = grain
        self.domain = ServingDispatchDomain(self.groups, dynamic=dynamic)
        self.poas = POAS(self.domain, cache=PlanCache() if cache else None)
        self.pump: ObservationPump | None = None
        if self.domain.dyn is not None:
            self.pump = ObservationPump(self.domain.dyn,
                                        [g.name for g in self.groups])
        self.last_plan: POASPlan | None = None
        self.tenant = None             # set by attach() (DESIGN.md §13)
        self._pending: list[Request] = []
        self._lock = threading.Lock()

    def split(self, requests: Sequence[Request]) -> list[list[Request]]:
        if not requests:
            self.last_plan = None      # never expose a previous batch's plan
            return [[] for _ in self.groups]
        plan = self.poas.plan(RequestBatch(requests=tuple(requests)))
        self.last_plan = plan
        # apply the (possibly cached) index packing to THIS batch's requests
        return plan.adapted.assign(requests)

    # -- continuous batching ------------------------------------------------

    def admit(self, *requests: Request) -> None:
        """Queue requests for the next dispatch (safe to call from serving
        threads while a batch is in flight)."""
        with self._lock:
            self._pending.extend(requests)

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def dispatch_pending(self) -> list[list[Request]]:
        """Drain the admission queue into a planned dispatch (empty buckets
        when nothing is pending)."""
        with self._lock:
            batch, self._pending = self._pending, []
        return self.split(batch)

    def complete(self, group_index: int, requests: Sequence[Request],
                 seconds: float) -> None:
        """Report one bucket's measured generation time; in dynamic mode it
        is pumped into that group's model (no-op for static dispatchers)."""
        if self.pump is None or not requests:
            return
        tokens = float(sum(len(r.tokens) + r.max_new_tokens
                           for r in requests))
        self.pump.observe(self.groups[group_index].name, tokens, seconds)

    # -- shared-runtime tenancy (DESIGN.md §13) -----------------------------

    def attach(self, runtime, name: str = "serving", qos=None):
        """Register this dispatcher's domain as a tenant on a shared
        multi-tenant ``CoExecutionRuntime``: batches submitted through
        ``submit_batch`` interleave with other tenants' jobs on the shared
        carried-clock timeline under weighted-fair, SLO-aware admission
        (latency-tier serving traffic can preempt batch tenants).  The
        tenant's pump *replaces* the dispatcher's private one, so
        completions reported through either path re-fit the same models."""
        self.tenant = runtime.register(name, self.domain, qos)
        if self.tenant.pump is not None:
            self.pump = self.tenant.pump
        return self.tenant

    def submit_batch(self, requests: Sequence[Request], *,
                     deadline_s: float | None = None,
                     arrival: float | None = None):
        """Submit one request batch as a ``StreamJob`` on the attached
        runtime (``attach`` first).  The job's plan carries the same
        ``DispatchPlan`` the ``split`` facade would produce — recover the
        buckets with ``job.plan.adapted.assign(requests)``; an infeasible
        ``deadline_s`` raises at the job, never dispatching a ticket."""
        if self.tenant is None:
            raise RuntimeError("attach() this dispatcher to a runtime "
                               "before submit_batch()")
        return self.tenant.submit(RequestBatch(requests=tuple(requests)),
                                  deadline_s=deadline_s, arrival=arrival)

    # -- prediction ---------------------------------------------------------

    def predicted_makespan(self, buckets: Sequence[Sequence[Request]]) -> float:
        """Predicted completion of a bucketed dispatch on the *current*
        (possibly re-fitted) group models — priced on the same timeline
        engine the solver and simulator use, so copy/link time is included
        for groups that have it (it used to price ``g.compute(ops)`` only,
        disagreeing with the solver/simulator/executor contract)."""
        groups = list(self.domain.predict())
        ops = [float(sum(len(r.tokens) + r.max_new_tokens for r in reqs))
               for g, reqs in zip(groups, buckets)]
        ops += [0.0] * (len(groups) - len(ops))   # callers may pass fewer
        tl = simulate_timeline(groups, ops, 1, 1,
                               topology=self.domain.topology)
        return tl.makespan
