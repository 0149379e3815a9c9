"""Persistent streaming co-execution runtime — plan → execute → observe →
re-plan as one loop (DESIGN.md §9).

The paper runs POAS once per application; its §3.4.2 dynamic mode, and any
deployment serving sustained traffic, need a *continuous* loop instead.
``CoExecutionRuntime`` keeps the whole pipeline alive across plans:

* an **admission queue** of POAS workloads for any registered ``Domain``;
* a planner thread running the four phases per job through the shared
  ``POAS``/``PlanCache`` (a cache hit skips the solve entirely);
* **plan-carry-over**: each plan's timeline is rebased onto the previous
  plan's carried link/device clocks (``core.bus.ClockState``), so plan
  k+1's input copies overlap plan k's tail instead of waiting for a global
  barrier;
* execution through the persistent ``StreamCore`` (long-lived per-device
  workers + per-link ticket buses, ``core.executor``) or through a
  deterministic **virtual-time** backend that prices the measured run on
  ground-truth device models;
* an **observation pump** converting each measured ``Timeline``'s compute
  events into ``DynamicScheduler.observe`` calls, so model re-fits,
  ``PlanCache`` invalidation, and re-planning happen automatically inside
  the loop — a device that starts throttling mid-stream sheds load within
  a few jobs without any caller wiring;
* **multi-tenant admission** (DESIGN.md §13): one runtime serves jobs from
  many registered ``Tenant``s (each its own domain, ``POAS``/``PlanCache``,
  observation pump, and ``QoS`` policy) through a single weighted-fair,
  deadline-aware admission queue onto ONE shared ``StreamCore`` and one
  carried-clock timeline — with SLO rejection at admission (an infeasible
  deadline never issues a ticket) and priority preemption of a batch-tier
  job's not-yet-started frontier when a latency-tier job arrives (built on
  the §11 ``reissue``/``rebase_partial`` splice machinery, unchanged).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Iterable, Mapping, Sequence

from .bus import (ClockState, GraphTimelineSpec, Timeline, _has_copy,
                  carry_clocks, graph_finish_times)
from .device_model import (DeviceProfile, LinearTimeModel, RooflineTimeModel)
from .domain import (Domain, PlanCache, QoS, TIER_BATCH, TIER_LATENCY,
                     Workload)
from .executor import DeviceTask, StreamCore
from .framework import POAS, POASPlan
from .optimize import SolveContextCache, solve_list_schedule
from .schedule import DynamicScheduler


# ---------------------------------------------------------------------------
# Observation pump — measured timelines feed the Predict phase
# ---------------------------------------------------------------------------


class ObservationPump:
    """Converts measured timelines into ``DynamicScheduler.observe`` calls.

    One pump is the single feedback path for every layer: the runtime feeds
    each job's measured compute events (``feed``), the serving dispatcher
    feeds per-bucket generation times, and the hetero train-step loop feeds
    per-pod step times (both via ``observe``).  ``time_scale`` converts
    measured wall seconds back to model seconds when execution is
    deliberately time-scaled (sleep-based testbeds).
    """

    def __init__(self, dyn: DynamicScheduler,
                 device_names: Sequence[str], *, time_scale: float = 1.0):
        self.dyn = dyn
        self.index = {name: i for i, name in enumerate(device_names)}
        self.time_scale = time_scale
        self.observations = 0

    def observe(self, device: str, ops: float, seconds: float) -> None:
        """One measured (ops, seconds) sample for a device, by name."""
        self.dyn.observe(self.index[device], float(ops),
                         float(seconds) / self.time_scale)
        self.observations += 1

    def feed(self, measured: Timeline,
             ops_by_device: Mapping[str, float]) -> int:
        """Pump every device's measured compute time (chunk durations
        summed) into the scheduler; returns the number of observations."""
        fed = 0
        for name, ops in ops_by_device.items():
            if name not in self.index or ops <= 0.0:
                continue
            seconds = sum(e.duration for e in measured.device_events(name)
                          if e.kind == "compute")
            if seconds > 0.0:
                self.observe(name, ops, seconds)
                fed += 1
        return fed

    def feed_tasks(self, measured: Timeline,
                   task_ops: Sequence[tuple[str, str, float]]) -> int:
        """Per-task observations for DAG jobs: each ``(task, device, ops)``
        row becomes its own ``observe`` call with that task's measured
        compute time — a single job yields many distinct (ops, seconds)
        samples per device, so the regression gets rank from one job
        instead of needing a stream of differently-sized jobs."""
        fed = 0
        for task, device, ops in task_ops:
            if device not in self.index or ops <= 0.0:
                continue
            seconds = sum(e.duration for e in measured.events
                          if e.task == task and e.device == device
                          and e.kind == "compute")
            if seconds > 0.0:
                self.observe(device, ops, seconds)
                fed += 1
        return fed


# ---------------------------------------------------------------------------
# Ground-truth helpers (testbeds: what the hardware *really* does)
# ---------------------------------------------------------------------------


def throttled(device: DeviceProfile, factor: float) -> DeviceProfile:
    """Ground-truth profile computing ``factor``× slower than ``device``
    (the paper's overheating scenario / a straggling pod)."""
    m = device.compute
    if isinstance(m, LinearTimeModel):
        slow = LinearTimeModel(a=m.a * factor, b=m.b * factor)
    elif isinstance(m, RooflineTimeModel):
        slow = RooflineTimeModel(peak_ops_per_s=m.peak_ops_per_s / factor,
                                 hbm_bytes_per_s=m.hbm_bytes_per_s / factor,
                                 bytes_per_op=m.bytes_per_op,
                                 overhead_s=m.overhead_s * factor)
    else:  # pragma: no cover - exotic model
        raise TypeError(f"cannot throttle {type(m).__name__}")
    return dataclasses.replace(device, compute=slow)


def copy_throttled(device: DeviceProfile, factor: float) -> DeviceProfile:
    """Ground-truth profile whose host<->device copies run ``factor``×
    slower than ``device`` (a degraded PCIe lane, a saturated NIC).  The
    engine prices copies from the device ``CopyModel`` capped by link
    bandwidth, so this slows measured copy events in both the virtual and
    the sleep-based threaded backends — the *link* straggler scenario."""
    c = device.copy
    if factor == 1.0 or math.isinf(c.bandwidth_bytes_per_s):
        return device
    slow = dataclasses.replace(
        c, bandwidth_bytes_per_s=c.bandwidth_bytes_per_s / factor,
        latency_s=c.latency_s * factor)
    return dataclasses.replace(device, copy=slow)


TruthFn = Callable[[int, DeviceProfile], DeviceProfile]
"""(job uid, planned device) -> the profile the hardware really runs at.

Must be anchored to FIXED ground-truth profiles: the planned device passed
in may already carry a re-fitted model, and deriving the truth from it
(e.g. ``throttled(planned, 2)``) compounds the slowdown on every re-fit —
the model chases its own tail to infinity.  Use ``truth_from_profiles``.
"""


def truth_from_profiles(base: Sequence[DeviceProfile],
                        slowdown: Callable[[int, str], float] | None = None,
                        copy_slowdown: Callable[[int, str], float] | None = None
                        ) -> TruthFn:
    """A ``TruthFn`` pinned to fixed ground-truth ``base`` profiles.

    ``slowdown(job_uid, device_name)`` returns the compute throttle factor
    in effect for that job (1.0 = nominal) — e.g. a device overheating 2x
    from job 8 onward is ``lambda uid, name: 2.0 if uid >= 8 and
    name == "xpu" else 1.0``.  ``copy_slowdown`` is the same contract for
    the device's host<->device copy bandwidth (the link-straggler
    scenario the copy-slack monitor catches).
    """
    by_name = {d.name: d for d in base}

    def fn(uid: int, planned: DeviceProfile) -> DeviceProfile:
        d = by_name.get(planned.name, planned)
        f = slowdown(uid, d.name) if slowdown is not None else 1.0
        out = throttled(d, f) if f != 1.0 else d
        cf = copy_slowdown(uid, d.name) if copy_slowdown is not None else 1.0
        return copy_throttled(out, cf)

    return fn


def model_sleep_tasks(truth: TruthFn | None = None, *,
                      time_scale: float = 1.0) -> "TaskFactory":
    """Task factory whose stages sleep their ground-truth model durations —
    the simulated-testbed execution backend for the threaded runtime.

    ``truth`` substitutes what the device *really* does for what the plan
    believes (e.g. a mid-stream throttle); it is evaluated at execution
    time keyed on the job uid, so throttles are deterministic regardless of
    thread timing.  ``time_scale`` shrinks the sleeps; pair it with the
    runtime's ``time_scale`` so the pump converts back to model seconds.
    """

    def factory(job: "StreamJob", plan: POASPlan) -> list[DeviceTask]:
        spec = plan.schedule.spec
        if spec is None:
            raise ValueError("model_sleep_tasks needs Schedule.spec "
                             "(every shipped domain provides it)")
        if isinstance(spec, GraphTimelineSpec):
            return _graph_sleep_tasks(job, spec, truth, time_scale)
        kinds = {(e.device, e.kind) for e in plan.schedule.timeline.events}
        tasks: list[DeviceTask] = []
        for d, c in zip(spec.devices, spec.ops):
            if c <= 0.0:
                continue

            def true_dev(d=d) -> DeviceProfile:
                return truth(job.uid, d) if truth is not None else d

            def sleep_in(d=d, c=c):
                time.sleep(true_dev(d).copy.in_time(c, spec.n, spec.k)
                           * time_scale)

            def sleep_compute(d=d, c=c):
                time.sleep(true_dev(d).compute(c) * time_scale)

            def sleep_out(d=d, c=c):
                time.sleep(true_dev(d).copy.out_time(c, spec.n, spec.k)
                           * time_scale)

            has_in = (d.name, "copy_in") in kinds
            has_out = (d.name, "copy_out") in kinds
            tasks.append(DeviceTask(device=d.name,
                                    copy_in=sleep_in if has_in else None,
                                    compute=sleep_compute,
                                    copy_out=sleep_out if has_out else None))
        return tasks

    return factory


def _graph_sleep_tasks(job: "StreamJob", spec: GraphTimelineSpec,
                       truth: TruthFn | None,
                       time_scale: float) -> list[DeviceTask]:
    """Sleep-stage ``DeviceTask``s for a task-graph plan: one stage group
    per DAG task (``task``/``deps`` set so the StreamCore blocks on
    upstream completion), durations re-priced per stage under the
    ground-truth profiles via the spec's own engine rebase."""
    truth_devs = [truth(job.uid, d) if truth is not None else d
                  for d in spec.devices]
    seconds = spec.stage_seconds(truth_devs)
    parents = spec.parents_of()
    tasks: list[DeviceTask] = []
    # planned order, NOT node order: each device's worker runs its stage
    # groups strictly in dispatch order, so a same-device dependency queued
    # out of topological order would deadlock the worker on its own queue
    for i in spec.order:
        t, a = spec.tasks[i], spec.assign[i]
        if a < 0:
            continue
        dev = spec.devices[a].name
        stage = seconds.get(t.name, {})

        def sleeper(s: float):
            return (lambda: time.sleep(s * time_scale))

        tasks.append(DeviceTask(
            device=dev,
            copy_in=sleeper(stage["copy_in"]) if stage.get("copy_in")
            else None,
            compute=sleeper(stage.get("compute", 0.0)),
            copy_out=sleeper(stage["copy_out"]) if stage.get("copy_out")
            else None,
            task=t.name, deps=parents.get(t.name, ())))
    return tasks


# ---------------------------------------------------------------------------
# Stream jobs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReplanRecord:
    """One mid-graph re-plan splice on a live DAG job (DESIGN.md §11).

    ``frozen`` are the completed/running tasks kept in place, ``spliced``
    the not-yet-started tasks whose tickets were revoked and re-issued
    under ``spec`` (the re-solved full-graph spec, frozen assignments
    pinned); ``planned`` is the frontier's re-planned partial timeline —
    its per-link ticket order is what the executor spliced in, and what
    ``verify_stream_invariants`` checks the measured grant order against.
    """

    at: float                    # stream time (model seconds) of the splice
    straggler: str               # task (or preempting job id) that tripped it
    frozen: tuple[str, ...]
    spliced: tuple[str, ...]
    spec: GraphTimelineSpec
    planned: Timeline
    # what tripped the splice: "straggler" (compute slack), "copy-straggler"
    # (link slack), or "preempt" (a latency-tier arrival revoked this
    # batch-tier job's frontier)
    reason: str = "straggler"


class AdmissionRejected(RuntimeError):
    """The job's deadline was infeasible at admission: the engine-priced
    predicted completion on the carried clocks exceeded it, so the job was
    rejected *before* dispatch — no ticket was ever issued (DESIGN.md §13).
    """

    def __init__(self, uid: int, predicted: float, deadline: float):
        super().__init__(
            f"job {uid}: predicted completion {predicted:.6g}s exceeds "
            f"deadline {deadline:.6g}s — rejected at admission")
        self.uid = uid
        self.predicted = predicted
        self.deadline = deadline


@dataclasses.dataclass
class StreamJob:
    """One admitted workload's lifecycle through the loop."""

    uid: int
    workload: Workload
    plan: POASPlan | None = None
    planned: Timeline | None = None    # rebased onto carried clocks
    measured: Timeline | None = None
    error: BaseException | None = None
    epoch_at_plan: int = 0             # DynamicScheduler.epoch when planned
    replans: list[ReplanRecord] = dataclasses.field(default_factory=list)
    # multi-tenant lifecycle (DESIGN.md §13)
    tenant: "Tenant | None" = None
    arrival: float = 0.0               # stream-axis submit time
    deadline: float | None = None      # absolute stream-axis SLO deadline
    vstart: float = 0.0                # SFQ start tag (fair-admission order)
    vft: float = 0.0                   # SFQ finish tag (tenant's next floor)
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    # mid-execution bookkeeping (threads: the straggler monitor runs on
    # device worker threads; virtual: the deterministic replay)
    _fed_tasks: set = dataclasses.field(default_factory=set)
    _planned_compute: dict = dataclasses.field(default_factory=dict)
    _planned_copy: dict = dataclasses.field(default_factory=dict)
    _handle: object = None
    _replan_attempts: int = 0
    _preempt_attempts: int = 0
    _admit_time: float = 0.0           # when the admission queue released it
    _base_clocks: ClockState | None = None   # virtual: clocks it priced from
    # tasks whose straggler trigger was evaluated and produced no splice
    # (the re-solve confirmed the lock-in): don't re-solve for them again
    _checked_tasks: set = dataclasses.field(default_factory=set)
    _replan_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock)
    # every rescue re-solves this job's one DAG: reuse the priority order
    # and per-(device, task) duration tables across re-plans (§14) — only
    # clocks/pinned/ext change, and those are per-state, not per-context
    _solve_cache: SolveContextCache = dataclasses.field(
        default_factory=SolveContextCache)

    def wait(self, timeout: float | None = None) -> "StreamJob":
        if not self._done.wait(timeout):
            raise TimeoutError(f"job {self.uid} still running")
        if self.error is not None:
            raise self.error
        return self

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def rejected(self) -> bool:
        """True when SLO admission control rejected the job (never ran)."""
        return isinstance(self.error, AdmissionRejected)

    @property
    def start(self) -> float:
        if self.measured is None:
            return 0.0
        return min((e.start for e in self.measured.events), default=0.0)

    @property
    def finish(self) -> float:
        return self.measured.makespan if self.measured else 0.0

    @property
    def span(self) -> float:
        """Measured latency of this job (first stage start → last end)."""
        return self.finish - self.start

    @property
    def latency(self) -> float:
        """Submit-to-completion latency on the stream axis (finish − the
        arrival time) — queueing delay included, unlike ``span``."""
        return max(0.0, self.finish - self.arrival)

    @property
    def final_spec(self):
        """The spec the job actually executed under: the last re-plan's
        spec when the job was spliced mid-graph, else the planned one."""
        if self.replans:
            return self.replans[-1].spec
        return self.plan.schedule.spec if self.plan is not None else None


TaskFactory = Callable[[StreamJob, POASPlan], Sequence[DeviceTask]]

def _ancestor_closed_freeze(spec: GraphTimelineSpec,
                            started: Sequence[str]
                            ) -> tuple[list[str], list[str]]:
    """(frozen, frontier) for a mid-graph re-plan: the started set closed
    over ancestors, and the migratable remainder, both in task order.

    A stage group counts as started the moment its device worker picks it
    up — possibly while a cross-device parent is still pending (the group
    blocks in its dependency wait).  That consumer's stages were built
    against the parent's original placement, so the parent must freeze in
    place too: without the closure the progress snapshot would not be
    ancestor-closed and ``frontier_subgraph`` would (rightly) reject it.
    """
    parents = spec.parents_of()
    frozen = set(started)
    stack = list(started)
    while stack:
        for u in parents.get(stack.pop(), ()):
            if u not in frozen:
                frozen.add(u)
                stack.append(u)
    frozen_l = [t.name for t in spec.tasks if t.name in frozen]
    frontier = [t.name for t, a in zip(spec.tasks, spec.assign)
                if a >= 0 and t.name not in frozen]
    return frozen_l, frontier


def _planned_copy_map(spec: GraphTimelineSpec,
                      devices: Sequence[DeviceProfile] | None = None
                      ) -> dict[tuple[str, str], float]:
    """Planned per-``(task, kind)`` copy seconds — what the copy-slack
    monitor compares measured link transfers against (the link-straggler
    counterpart of ``_planned_compute``)."""
    out: dict[tuple[str, str], float] = {}
    for task, stages in spec.stage_seconds(devices).items():
        for kind, s in stages.items():
            if kind != "compute" and s > 0.0:
                out[(task, kind)] = s
    return out


def _copy_refit(devices: Sequence[DeviceProfile], events,
                planned_stage: Mapping[str, Mapping[str, float]],
                until: float = math.inf) -> list[DeviceProfile]:
    """Fold measured copy slack into the re-solve's device profiles.

    Compute models re-fit through the ``ObservationPump``, but nothing
    observes the ``CopyModel`` — without this, a copy-straggler trip hands
    the re-solve the same nominal link speeds the lock-in was planned
    under, and it dutifully confirms the lock-in.  Scale each device's
    copy model by the worst measured/planned ratio its link showed by the
    detection time, so the re-solve prices the degraded lane honestly."""
    ratio = {d.name: 1.0 for d in devices}
    for e in events:
        if e.kind not in ("copy_in", "copy_out") or e.task is None:
            continue
        if e.end > until + 1e-12:
            continue
        ps = planned_stage.get(e.task, {}).get(e.kind, 0.0)
        if ps > 0.0 and e.duration > ps and e.device in ratio:
            ratio[e.device] = max(ratio[e.device], e.duration / ps)
    return [copy_throttled(d, ratio[d.name]) if ratio[d.name] > 1.0 else d
            for d in devices]


# Per-descent evaluation cap for the threaded mid-graph re-solve: it runs
# in-line on the straggling device's worker thread (freezing its queue), and
# on a serialized bus the other devices' first copies wait on the straggler's
# revoked grants — every engine evaluation directly delays the whole splice.
_REPLAN_MAX_EVALS = 80

# Predicted-gain gate: splice only when the re-solved frontier beats the
# locked-in plan (re-priced under the same re-fitted models, ext and clocks)
# by at least this factor — a marginal prediction is not worth the splice.
_REPLAN_MIN_GAIN = 1.05


# ---------------------------------------------------------------------------
# Multi-tenant admission (DESIGN.md §13)
# ---------------------------------------------------------------------------


class FairAdmission:
    """Start-time Fair Queueing (SFQ) over tenants — pure tag algebra, no
    clock reads, so the admission *order* is a deterministic function of
    the submit sequence (Goyal et al.'s SFQ, the classic weighted-fair
    discipline that needs no fluid-model reference clock).

    Each job is stamped at submit with a virtual start tag
    ``S = max(v, F_tenant)`` and finish tag ``F = S + cost / weight``
    (``F_tenant`` = the tenant's previous job's finish tag); jobs are
    admitted in increasing start-tag order and the system virtual time
    ``v`` advances to the start tag of each job entering service.  While
    two tenants stay backlogged, their admitted-work ratio tracks their
    weight ratio within one job of slack — the property
    ``tests/test_multi_tenant.py`` checks under hypothesis.
    """

    def __init__(self) -> None:
        self._vtime = 0.0
        self._last_finish: dict[str, float] = {}

    def stamp(self, tenant: str, weight: float,
              cost: float) -> tuple[float, float]:
        """Tag one submitted job; returns ``(vstart, vfinish)``."""
        if weight <= 0.0:
            raise ValueError("weight must be > 0")
        vstart = max(self._vtime, self._last_finish.get(tenant, 0.0))
        vfinish = vstart + max(0.0, float(cost)) / float(weight)
        self._last_finish[tenant] = vfinish
        return vstart, vfinish

    def on_admit(self, vstart: float) -> None:
        """A job with this start tag entered service: advance ``v``."""
        if vstart > self._vtime:
            self._vtime = vstart


class Tenant:
    """One registered workload source on a shared ``CoExecutionRuntime``.

    A tenant owns the *domain-specific* half of the loop — its ``Domain``,
    ``POAS`` + ``PlanCache``, ``DynamicScheduler`` and ``ObservationPump``
    — while the runtime owns the shared half: one ``StreamCore`` (or the
    virtual-time engine), one carried-clock timeline, one weighted-fair
    admission queue.  Per-tenant pumps mean one tenant's measurements
    re-fit only its own models and invalidate only its own cache.
    """

    def __init__(self, name: str, domain: Domain, qos: QoS,
                 runtime: "CoExecutionRuntime", *, cache: bool = True,
                 feedback: bool = True):
        self.name = name
        self.domain = domain
        self.qos = qos
        self.runtime = runtime
        self.poas = POAS(domain, cache=PlanCache() if cache else None)
        self.dyn: DynamicScheduler | None = getattr(domain, "dyn", None)
        self.pump: ObservationPump | None = None
        if feedback and self.dyn is not None:
            names = [d.name for d in domain.predict()]
            self.pump = ObservationPump(self.dyn, names,
                                        time_scale=runtime.time_scale)
        self.jobs: list[StreamJob] = []
        self.rejected = 0

    @property
    def plan_cache(self) -> PlanCache | None:
        return self.poas.cache

    def submit(self, workload: Workload, *,
               deadline_s: float | None = None,
               arrival: float | None = None) -> StreamJob:
        return self.runtime.submit(workload, tenant=self,
                                   deadline_s=deadline_s, arrival=arrival)

    def stats(self) -> dict:
        done = [j for j in self.jobs if j.done and j.error is None]
        lats = sorted(j.latency for j in done)
        p = lambda q: lats[max(0, math.ceil(q * len(lats)) - 1)] \
            if lats else 0.0
        return {
            "jobs_done": len(done),
            "rejected": self.rejected,
            "p50_latency_s": p(0.50),
            "p95_latency_s": p(0.95),
            "p99_latency_s": p(0.99),
            "observations": self.pump.observations if self.pump else 0,
            "refit_epoch": self.dyn.epoch if self.dyn else 0,
            "plan_cache": self.poas.cache.stats() if self.poas.cache else {},
        }


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------


class CoExecutionRuntime:
    """Persistent plan→execute→observe→re-plan loop over one shared core.

    Single-tenant (the classic shape): construct with a ``domain`` and
    ``submit`` workloads.  Multi-tenant (DESIGN.md §13): ``register`` any
    number of tenants — each its own ``Domain``, ``POAS``/``PlanCache``
    and observation pump, all sharing ONE ``StreamCore`` (or virtual
    engine), one ``BusTopology`` link namespace and one carried-clock
    timeline.  Admission is weighted-fair (SFQ over ``QoS.weight`` within
    strict ``QoS.tier`` priority), deadline-aware (an infeasible SLO is
    rejected before a ticket is issued), and — with ``preempt`` on — a
    latency-tier arrival revokes batch-tier jobs' not-yet-started tickets
    and splices their re-solved frontiers behind it.

    Parameters
    ----------
    domain:
        any registered POAS ``Domain``; it becomes the ``"default"``
        tenant (weight 1, batch tier).  If it carries a
        ``DynamicScheduler`` (``domain.dyn``) and ``feedback`` is on,
        measured timelines are pumped back into it.  ``None`` starts an
        empty runtime — ``register`` tenants before submitting.
    executor:
        ``"threads"`` — the real ``StreamCore`` (long-lived per-device
        workers, per-link ticket buses surviving across plans); stage
        callables come from ``task_factory`` (default: ground-truth sleeps
        via ``model_sleep_tasks``).
        ``"virtual"`` — deterministic virtual time: the measured timeline is
        the engine's pricing of the plan under the ground-truth profiles
        (``truth``), chained on carried measured clocks.  Planning latency
        does not pollute the stream, so throughput comparisons are exact.
    carry_clocks:
        rebase each plan onto the previous plan's carried link/device
        clocks (overlapped back-to-back plans).  Off = a global barrier
        between plans.
    feedback:
        pump measured compute events into ``domain.dyn`` after each job
        (model re-fit → ``PlanCache`` invalidation → re-plan, automatically).
    max_inflight:
        how many jobs may be planned ahead of the oldest unfinished one.
        In virtual mode this sets the observation lag (a plan dispatched
        while k jobs are in flight cannot have seen their measurements).
    replan:
        mid-graph re-planning (DESIGN.md §11): while a DAG job executes,
        per-task measurements feed the pump *during* execution, and a task
        whose measured compute exceeds ``straggler_threshold`` × its
        planned time freezes the completed/running tasks, re-solves the
        not-yet-started frontier under the re-fitted models (assignments
        pinned, clocks carried), and splices the new assignment into the
        live run via the StreamCore's ticket revoke/re-issue.  In virtual
        mode the same protocol is replayed deterministically at the moment
        the first straggling compute would have finished.
    straggler_threshold:
        measured/planned per-task compute slack ratio that triggers a
        re-plan (needs ``replan=True`` and a dynamic domain).
    replan_min_frontier:
        minimum number of not-yet-started tasks worth re-solving for.
    max_replans_per_job:
        re-plan attempts allowed per job (1 = classic one-shot rescue).
    admission:
        ``"fair"`` — SFQ weighted-fair order within strict tier priority
        (with a single tenant this degenerates to FIFO exactly);
        ``"fifo"`` — raw submission order (the baseline the benchmark
        compares against).
    preempt:
        priority preemption: a ``TIER_LATENCY`` job's dispatch revokes
        every running batch-tier DAG job's not-yet-started tickets and
        splices the re-solved frontier behind it (§11 machinery, reason
        ``"preempt"``).
    """

    def __init__(self, domain: Domain | None = None, *,
                 executor: str = "threads",
                 task_factory: TaskFactory | None = None,
                 truth: TruthFn | None = None,
                 cache: bool = True,
                 feedback: bool = True,
                 carry_clocks: bool = True,
                 max_inflight: int = 2,
                 time_scale: float = 1.0,
                 replan: bool = False,
                 straggler_threshold: float = 1.5,
                 replan_min_frontier: int = 2,
                 max_replans_per_job: int = 1,
                 admission: str = "fair",
                 preempt: bool = False):
        if executor not in ("threads", "virtual"):
            raise ValueError(f"unknown executor {executor!r}")
        if admission not in ("fair", "fifo"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.carry = bool(carry_clocks)
        self.max_inflight = max(1, int(max_inflight))
        self.executor = executor
        self.truth = truth
        self.time_scale = time_scale
        self.feedback = bool(feedback)
        self.admission_policy = admission
        self.preempt = bool(preempt)
        self.replan = bool(replan)
        self.straggler_threshold = float(straggler_threshold)
        self.replan_min_frontier = max(1, int(replan_min_frontier))
        self.max_replans_per_job = max(0, int(max_replans_per_job))
        self.jobs: list[StreamJob] = []
        self.tenants: dict[str, Tenant] = {}
        self._default_cache = bool(cache)
        self._default: Tenant | None = None
        self._task_factory = task_factory or model_sleep_tasks(
            truth, time_scale=time_scale)
        self._core = StreamCore() if executor == "threads" else None
        if self._core is not None:
            # per-task measurements flow DURING execution, not only at job
            # completion — the straggler monitor and the observation pumps
            # both hang off the core's event hook
            self._core.on_event = self._on_stream_event
        self._plan_clocks = ClockState()
        self._meas_clocks = ClockState()
        self._virtual_events: list = []
        self._virtual_finishes: dict[int, float] = {}   # uid -> stream end
        self._vnow = 0.0                   # virtual admission clock
        self._dispatched = 0
        self._last_virtual: StreamJob | None = None
        self._preempt_pending: tuple | None = None
        self._pending_obs: list[StreamJob] = []   # virtual-mode obs lag
        self._pending: list[StreamJob] = []       # submitted, not admitted
        self._admission = FairAdmission()
        self._inflight = threading.Semaphore(self.max_inflight)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._hold = False
        self._closed = False
        if domain is not None:
            self.register("default", domain, QoS())
        self._planner = threading.Thread(target=self._plan_loop,
                                         name="poas-planner", daemon=True)
        self._planner.start()

    # -- tenants ------------------------------------------------------------

    def register(self, name: str, domain: Domain,
                 qos: QoS | None = None, *,
                 cache: bool | None = None) -> Tenant:
        """Register one tenant (its own POAS/cache/pump) on the shared
        core.  The first registered tenant is the default ``submit``
        target and backs the legacy ``.domain/.poas/.dyn/.pump`` aliases."""
        with self._cv:
            if self._closed:
                raise RuntimeError("runtime is shut down")
            if name in self.tenants:
                raise ValueError(f"tenant {name!r} already registered")
            ten = Tenant(name, domain, qos or QoS(), self,
                         cache=self._default_cache if cache is None
                         else cache,
                         feedback=self.feedback)
            self.tenants[name] = ten
            if self._default is None:
                self._default = ten
            return ten

    # single-tenant aliases: the pre-§13 API (and the shipped tests) reach
    # the loop's domain half through the runtime object itself
    @property
    def domain(self) -> Domain | None:
        return self._default.domain if self._default else None

    @property
    def poas(self) -> POAS | None:
        return self._default.poas if self._default else None

    @property
    def dyn(self) -> DynamicScheduler | None:
        return self._default.dyn if self._default else None

    @property
    def pump(self) -> ObservationPump | None:
        return self._default.pump if self._default else None

    # -- admission ----------------------------------------------------------

    def submit(self, workload: Workload, *, tenant: Tenant | None = None,
               deadline_s: float | None = None,
               arrival: float | None = None) -> StreamJob:
        """Admit one workload; returns immediately with its ``StreamJob``.

        ``deadline_s`` (relative) overrides the tenant's ``QoS.deadline_s``
        for this job; the absolute deadline is ``arrival + deadline_s`` on
        the stream axis.  ``arrival`` places the submit on the virtual
        stream axis (model seconds) for open-loop experiments — virtual
        mode only; in threads mode the wall clock is the arrival.
        """
        now = self._core.now() / self.time_scale \
            if self._core is not None else 0.0
        with self._cv:
            if self._closed:
                raise RuntimeError("runtime is shut down")
            ten = tenant if tenant is not None else self._default
            if ten is None:
                raise ValueError("no tenant registered: construct with a "
                                 "domain or call register() first")
            job = StreamJob(uid=len(self.jobs), workload=workload,
                            tenant=ten)
            job.arrival = float(arrival) if arrival is not None else now
            dl = deadline_s if deadline_s is not None else ten.qos.deadline_s
            if dl is not None:
                job.deadline = job.arrival + float(dl)
            job.vstart, job.vft = self._admission.stamp(
                ten.name, ten.qos.weight, float(workload.total_ops()))
            self.jobs.append(job)
            ten.jobs.append(job)
            self._pending.append(job)
            self._cv.notify()
        return job

    def pause_admission(self) -> None:
        """Hold the admission queue (submissions still accepted): lets an
        open-loop experiment enqueue its whole arrival schedule before any
        job is planned, so the fair-admission order is deterministic."""
        with self._cv:
            self._hold = True

    def resume_admission(self) -> None:
        with self._cv:
            self._hold = False
            self._cv.notify_all()

    # -- elastic membership (DESIGN.md §16) ---------------------------------

    def device_leave(self, name: str, *,
                     at: float | None = None) -> list[ReplanRecord]:
        """Device departure as a first-class change-point.

        Two halves, generalizing the §11 straggler rescue:

        1. *Future admissions*: every tenant whose planning set contains
           ``name`` shrinks it (``Domain.set_devices`` hook — dynamic
           domains carry their re-fitted models for the survivors) and
           drops its ``PlanCache``, so the next plan solves on the
           smaller cluster.
        2. *In-flight jobs* (virtual mode): any job whose stream had not
           finished by ``at`` (default: the virtual admission clock) and
           whose not-yet-started frontier touches the departed device is
           frontier-frozen and re-solved with the device *banned* —
           assignments of started tasks pinned, clocks carried, spliced
           back into the stream with ``ReplanRecord(reason=
           "device-loss")``.  Banning (rather than deleting) keeps the
           job's spec device tuple and clock names index-aligned.

        Returns the splice records, one per rescued job.
        """
        with self._cv:
            if self._closed:
                raise RuntimeError("runtime is shut down")
            tenants = list(self.tenants.values())
        for ten in tenants:
            cur = list(ten.domain.predict())
            new = [d for d in cur if d.name != name]
            if len(new) == len(cur):
                continue
            if not new:
                raise ValueError(f"device {name!r} is the last device of "
                                 f"tenant {ten.name!r}; cannot leave")
            if hasattr(ten.domain, "set_devices"):
                ten.domain.set_devices(new)
            if ten.poas.cache is not None:
                ten.poas.cache.invalidate()
            if ten.pump is not None:
                ten.pump.index = {d.name: i for i, d in enumerate(new)}
        recs: list[ReplanRecord] = []
        if self.executor == "virtual":
            t = self._vnow if at is None else float(at)
            with self._lock:
                inflight = [j for j in self.jobs
                            if j.measured is not None and j.error is None
                            and j.measured.makespan > t + 1e-12]
            for job in inflight:
                rec = self._rescue_device_loss(job, name, t)
                if rec is not None:
                    recs.append(rec)
        return recs

    def device_join(self, device: DeviceProfile, *,
                    topology: "str | BusTopology | None" = None) -> None:
        """Device arrival: widen every tenant's planning set and drop its
        ``PlanCache`` — the next admission plans on the larger cluster.
        In-flight jobs are left alone (their specs never knew the
        joiner).  ``topology`` replaces the bus when the new device needs
        attach rows a custom topology lacks."""
        with self._cv:
            if self._closed:
                raise RuntimeError("runtime is shut down")
            tenants = list(self.tenants.values())
        for ten in tenants:
            if not hasattr(ten.domain, "set_devices"):
                continue
            cur = list(ten.domain.predict())
            if any(d.name == device.name for d in cur):
                continue
            ten.domain.set_devices(cur + [device], topology=topology)
            if ten.poas.cache is not None:
                ten.poas.cache.invalidate()
            if ten.pump is not None:
                ten.pump.index = {d.name: i
                                  for i, d in enumerate(cur + [device])}

    def run_stream(self, workloads: Sequence[Workload],
                   timeout: float | None = 120.0) -> list[StreamJob]:
        """Submit every workload, wait for all of them, return their jobs."""
        jobs = [self.submit(w) for w in workloads]
        for j in jobs:
            j.wait(timeout)
        return jobs

    def drain(self, timeout: float | None = 120.0) -> None:
        with self._lock:
            jobs = list(self.jobs)
        for j in jobs:
            j._done.wait(timeout)

    def shutdown(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._hold = False
            self._cv.notify_all()
        self._planner.join(timeout=60)
        if self._core is not None:
            self._core.shutdown()

    def __enter__(self) -> "CoExecutionRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- introspection ------------------------------------------------------

    @property
    def plan_cache(self) -> PlanCache | None:
        return self.poas.cache if self.poas is not None else None

    def stream_timeline(self) -> Timeline:
        """Every job's measured events on one time axis — the cross-plan
        invariant surface."""
        if self._core is not None:
            return self._core.stream_timeline()
        with self._lock:
            events = list(self._virtual_events)
        return Timeline(sorted(events, key=lambda e: (e.start, e.end)))

    def total_makespan(self) -> float:
        return self.stream_timeline().makespan

    def stats(self) -> dict:
        with self._lock:
            done = [j for j in self.jobs if j.done and j.error is None]
        spans = sorted(j.span for j in done)
        # nearest-rank percentile: ceil(q*n)-1, NOT int(q*n) — the latter
        # returns the max for p50 of two samples
        p = lambda q: spans[max(0, math.ceil(q * len(spans)) - 1)] \
            if spans else 0.0
        cache = self.plan_cache
        return {
            "jobs_done": len(done),
            "total_makespan_s": self.total_makespan(),
            "p50_job_span_s": p(0.50),
            "p95_job_span_s": p(0.95),
            "observations": self.pump.observations if self.pump else 0,
            "refit_epoch": self.dyn.epoch if self.dyn else 0,
            "replans": sum(len(j.replans) for j in done),
            "rejected": sum(t.rejected for t in self.tenants.values()),
            "plan_cache": cache.stats() if cache else {},
            "tenants": {name: t.stats()
                        for name, t in self.tenants.items()},
        }

    # -- the loop -----------------------------------------------------------

    def _next_clocks(self, timeline: Timeline, clocks: ClockState) -> ClockState:
        if self.carry:
            return carry_clocks(timeline, clocks)
        return ClockState(floor=max(timeline.makespan, clocks.floor))

    def _order_key(self, job: StreamJob):
        if self.admission_policy == "fifo":
            return (job.uid,)
        # strict tier priority, then SFQ start tags, uid as the tiebreak
        return (job.tenant.qos.tier, job.vstart, job.uid)

    def _select_locked(self) -> StreamJob:
        """Pick the next pending job (holding ``_cv``): min order key among
        the *eligible* set.  In threads mode every pending job has already
        arrived (the wall clock is the arrival); in virtual mode the
        open-loop slot model decides eligibility — an admission slot frees
        when the (d − max_inflight + 1)-th finish lands, the admission
        clock is the later of that slot and the previous admission, and
        only jobs arrived by then compete (an empty eligible set idles the
        queue forward to the next arrival)."""
        if self._core is not None:
            job = min(self._pending, key=self._order_key)
            job._admit_time = self._core.now() / self.time_scale
            return job
        m = self.max_inflight
        slot = 0.0
        if self._dispatched >= m:
            slot = sorted(self._virtual_finishes.values())[
                self._dispatched - m]
        t_adm = max(self._vnow, slot)
        elig = [j for j in self._pending if j.arrival <= t_adm + 1e-12]
        if not elig:
            t_adm = max(t_adm, min(j.arrival for j in self._pending))
            elig = [j for j in self._pending
                    if j.arrival <= t_adm + 1e-12]
        job = min(elig, key=self._order_key)
        self._vnow = t_adm
        job._admit_time = t_adm
        return job

    def _next_job(self) -> StreamJob | None:
        with self._cv:
            while True:
                if self._pending and not self._hold:
                    job = self._select_locked()
                    self._pending.remove(job)
                    self._admission.on_admit(job.vstart)
                    self._dispatched += 1
                    return job
                if self._closed and not self._pending:
                    return None
                self._cv.wait(timeout=0.1)

    def _plan_loop(self) -> None:
        while True:
            job = self._next_job()
            if job is None:
                return
            self._inflight.acquire()
            try:
                self._plan_and_dispatch(job)
            except AdmissionRejected as exc:
                job.error = exc
                job.tenant.rejected += 1
                with self._lock:
                    # the admission slot the job reserved frees instantly:
                    # a rejected job never runs
                    self._virtual_finishes[job.uid] = job._admit_time
                job._done.set()
                self._inflight.release()
            except BaseException as exc:
                job.error = exc
                job._done.set()
                self._inflight.release()

    def _plan_and_dispatch(self, job: StreamJob) -> None:
        ten = job.tenant
        if self.executor == "virtual":
            # flush observations old enough that a real pipeline would have
            # seen them (jobs completed before this one was planned); under
            # fair admission uids are NOT dispatch order, so the lag counts
            # completed-but-unfed jobs, not uid distance
            lag = self.max_inflight - 1
            while len(self._pending_obs) > lag:
                self._feed(self._pending_obs.pop(0))
        if ten.dyn is not None:
            job.epoch_at_plan = ten.dyn.epoch
        plan = ten.poas.plan(job.workload)
        job.plan = plan
        spec = plan.schedule.spec
        if spec is not None:
            base = self._plan_clocks
            if self._core is None and job.arrival > base.floor:
                # open-loop virtual stream: nothing of this job can be
                # planned to run before it arrived (carried clocks above
                # the floor still overlap)
                base = base.with_floor(job.arrival)
            planned = spec.rebase(base)
            self._check_deadline(job, spec, base, planned)
            job.planned = planned
            self._plan_clocks = self._next_clocks(planned,
                                                  self._plan_clocks)
        else:
            job.planned = plan.schedule.timeline
            if job.deadline is not None \
                    and job.planned.makespan > job.deadline + 1e-9:
                raise AdmissionRejected(job.uid, job.planned.makespan,
                                        job.deadline)
        if self.executor == "virtual":
            self._execute_virtual(job)
        else:
            self._execute_threads(job)

    def _check_deadline(self, job: StreamJob, spec, base: ClockState,
                        planned: Timeline) -> None:
        """SLO admission control: reject BEFORE any plan clock advances or
        any ticket is issued when the engine-priced completion of this
        plan on the carried clocks exceeds the job's absolute deadline —
        a rejected job leaves no trace on the shared timeline."""
        if job.deadline is None:
            return
        predicted = planned.makespan
        if self._core is not None:
            # the carried plan clocks can lag the wall (planner idle):
            # floor the prediction at 'now' so it cannot promise the past
            now = self._core.now() / self.time_scale
            if now > base.floor:
                predicted = spec.rebase(base.with_floor(now)).makespan
        if predicted > job.deadline + 1e-9:
            raise AdmissionRejected(job.uid, predicted, job.deadline)

    # -- virtual-time execution --------------------------------------------

    def _execute_virtual(self, job: StreamJob) -> None:
        spec = job.plan.schedule.spec
        if spec is None:
            raise ValueError("virtual execution needs Schedule.spec")
        truth_devs = [self.truth(job.uid, d) if self.truth else d
                      for d in spec.devices]
        base = self._meas_clocks
        if job.arrival > base.floor:
            # open-loop stream axis: no stage of this job can start before
            # it arrived; carried clocks above the floor still overlap
            base = base.with_floor(job.arrival)
        if self.preempt and job.tenant.qos.tier == TIER_LATENCY:
            base = self._preempt_virtual_prepare(job, base)
        job._base_clocks = base
        job.measured = spec.rebase(base, devices=truth_devs)
        if self.replan and isinstance(spec, GraphTimelineSpec):
            replayed = self._replay_replan_virtual(job, spec, truth_devs,
                                                   base, job.measured)
            if replayed is not None:
                job.measured = replayed
        self._meas_clocks = self._next_clocks(job.measured, self._meas_clocks)
        with self._lock:
            self._virtual_events.extend(job.measured.events)
            self._virtual_finishes[job.uid] = job.measured.makespan
        if self._preempt_pending is not None:
            self._preempt_virtual_commit(job)
        self._last_virtual = job
        self._pending_obs.append(job)
        job._done.set()
        self._inflight.release()

    def _preempt_virtual_prepare(self, lat: StreamJob,
                                 base: ClockState) -> ClockState:
        """Virtual-time priority preemption, half 1 (DESIGN.md §13):
        retract the last dispatched batch-tier job's not-yet-started
        frontier — in virtual time a stage's ticket is sound to revoke
        exactly when it had not started by the preemptor's admission —
        and hand back the clocks the frozen prefix leaves behind, so the
        latency job prices as if its tickets went ahead of the revoked
        ones.  Half 2 (``_preempt_virtual_commit``) re-solves and
        re-prices the victim's frontier behind the latency job."""
        victim = self._last_virtual
        if victim is None or victim.measured is None \
                or victim.tenant is lat.tenant \
                or victim.tenant.qos.tier <= lat.tenant.qos.tier \
                or victim._preempt_attempts >= 1:
            return base
        spec = victim.final_spec
        if not isinstance(spec, GraphTimelineSpec):
            return base
        t_p = lat._admit_time
        if victim.measured.makespan <= t_p + 1e-12:
            return base   # victim already finished: nothing to revoke
        first_start = {t.name: min((e.start for e in victim.measured.events
                                    if e.task == t.name), default=math.inf)
                       for t in spec.tasks}
        started, frontier = _ancestor_closed_freeze(
            spec, [t.name for t in spec.tasks
                   if first_start[t.name] < t_p - 1e-12])
        if not frontier:
            return base
        victim._preempt_attempts += 1
        started_set = set(started)
        frozen_events = [e for e in victim.measured.events
                         if e.task in started_set]
        # retract by event IDENTITY: task names collide across jobs that
        # share a graph template, so name-keyed removal would strip other
        # jobs' events from the stream
        retracted = {id(e) for e in victim.measured.events
                     if e.task not in started_set}
        with self._lock:
            self._virtual_events = [e for e in self._virtual_events
                                    if id(e) not in retracted]
        clocks = carry_clocks(Timeline(frozen_events),
                              victim._base_clocks or ClockState())
        self._meas_clocks = clocks
        self._preempt_pending = (victim, spec, started, tuple(frontier),
                                 frozen_events, t_p)
        if lat.arrival > clocks.floor:
            clocks = clocks.with_floor(lat.arrival)
        return clocks

    def _preempt_virtual_commit(self, lat: StreamJob) -> None:
        """Half 2 of the virtual preemption splice: with the latency job
        priced, re-solve the victim's revoked frontier (frozen tasks
        pinned, §11 machinery unchanged) on the clocks the frozen prefix
        AND the latency job leave behind, re-price it under ground truth,
        and splice it back into the stream."""
        victim, spec, started, frontier, frozen_events, t_p = \
            self._preempt_pending
        self._preempt_pending = None
        index = {t.name: i for i, t in enumerate(spec.tasks)}
        clocks = carry_clocks(
            lat.measured,
            carry_clocks(Timeline(frozen_events),
                         victim._base_clocks or ClockState()))
        devices = victim.tenant.dyn.snapshot() \
            if victim.tenant.dyn is not None else list(spec.devices)
        ext = self._frozen_ext(spec, started, Timeline(frozen_events),
                               t_p, devices, 1.0)
        pinned = {index[n]: spec.assign[index[n]] for n in started}
        res = solve_list_schedule(devices, spec.tasks, spec.edges,
                                  bus=spec.topology, pinned=pinned,
                                  ext=ext, clocks=clocks,
                                  seed_assign=spec.assign,
                                  max_evals=_REPLAN_MAX_EVALS,
                                  cache=victim._solve_cache)
        new_spec = dataclasses.replace(spec, devices=tuple(devices),
                                       assign=tuple(res.assign),
                                       order=tuple(res.order))
        ext_names = {spec.tasks[i].name: v for i, v in ext.items()}
        planned_frontier = new_spec.rebase_partial(clocks, ext=ext_names)
        truth_devs = [self.truth(victim.uid, d) if self.truth else d
                      for d in new_spec.devices]
        truth_frontier = new_spec.rebase_partial(clocks, ext=ext_names,
                                                 devices=truth_devs)
        victim.replans.append(ReplanRecord(
            at=t_p, straggler=f"j{lat.uid}", frozen=tuple(started),
            spliced=frontier, spec=new_spec, planned=planned_frontier,
            reason="preempt"))
        victim.measured = Timeline(sorted(
            frozen_events + list(truth_frontier.events),
            key=lambda e: (e.start, e.end)))
        self._meas_clocks = self._next_clocks(truth_frontier,
                                              self._meas_clocks)
        with self._lock:
            self._virtual_events.extend(truth_frontier.events)
            self._virtual_finishes[victim.uid] = victim.measured.makespan

    def _replay_replan_virtual(self, job: StreamJob,
                               spec: GraphTimelineSpec,
                               truth_devs: Sequence[DeviceProfile],
                               base: ClockState,
                               measured: Timeline) -> Timeline | None:
        """Deterministic virtual-time replay of the mid-graph re-plan
        protocol: detect the straggler at the moment its measured compute
        would have finished, freeze everything that had started by then,
        feed the observations the monitor would have seen, re-solve the
        frontier under the re-fitted models, and re-price it under the
        ground truth from the frozen tasks' carried clocks.  Returns the
        spliced timeline, or None when nothing triggers (or the re-solve
        confirms the lock-in)."""
        planned_s = {t.name: spec.devices[a].compute(t.ops)
                     for t, a in zip(spec.tasks, spec.assign) if a >= 0}
        comp = {e.task: e for e in measured.events if e.kind == "compute"}
        # trip candidates: compute slack (§11) AND copy slack — a stage
        # whose measured link transfer blows past its planned occupancy is
        # the same lock-in evidence, from the other side of the bus
        planned_stage = spec.stage_seconds()
        cand: list[tuple[float, str, str]] = []
        for n, e in comp.items():
            if planned_s.get(n, 0.0) > 0.0 and e.duration > \
                    self.straggler_threshold * planned_s[n]:
                cand.append((e.end, n, "straggler"))
        for e in measured.events:
            if e.kind in ("copy_in", "copy_out") and e.task is not None:
                ps = planned_stage.get(e.task, {}).get(e.kind, 0.0)
                if ps > 0.0 and e.duration > \
                        self.straggler_threshold * ps:
                    cand.append((e.end, e.task, "copy-straggler"))
        if not cand or job._replan_attempts >= self.max_replans_per_job:
            return None
        # detection moment: the first straggling stage to finish — the
        # earliest point a measured-vs-planned monitor has the evidence
        t_r, trip, reason = min(cand)
        first_start = {t.name: min((e.start for e in measured.events
                                    if e.task == t.name), default=math.inf)
                       for t in spec.tasks}
        # ancestor-close the freeze: the engine does not gate a task's
        # EXTERNAL input copy on its parents, so a consumer's first event
        # can precede a pending parent's — same closure as the threaded
        # monitor
        started, pend = _ancestor_closed_freeze(
            spec, [t.name for t in spec.tasks
                   if first_start[t.name] < t_r - 1e-12])
        index = {t.name: i for i, t in enumerate(spec.tasks)}
        if len(pend) < self.replan_min_frontier:
            return None
        if hasattr(job.workload, "frontier_subgraph"):
            job.workload.frontier_subgraph(started)
        # observations the tenant's pump would have delivered by t_r
        pump = job.tenant.pump if job.tenant is not None else None
        if pump is not None:
            for name in started:
                e = comp.get(name)
                if e is not None and e.end <= t_r + 1e-12 \
                        and name not in job._fed_tasks \
                        and spec.tasks[index[name]].ops > 0.0:
                    job._fed_tasks.add(name)
                    pump.observe(e.device,
                                 spec.tasks[index[name]].ops,
                                 e.duration * pump.time_scale)
        started_set = set(started)
        frozen_events = [e for e in measured.events
                         if e.task in started_set]
        # frozen tickets stay ahead of re-issued ones on every link, so the
        # frontier re-prices from the clocks the frozen tail leaves behind
        clocks = carry_clocks(Timeline(frozen_events), base)
        dyn = job.tenant.dyn if job.tenant is not None else None
        devices = dyn.snapshot() if dyn is not None \
            else list(spec.devices)
        if reason == "copy-straggler":
            devices = _copy_refit(devices, measured.events, planned_stage,
                                  until=t_r)
        # frozen pricing: same derivation as the threaded monitor (virtual
        # frozen events are complete, so the measured branches always hit)
        ext = self._frozen_ext(spec, started, Timeline(frozen_events),
                               t_r, devices, 1.0)
        pinned = {index[n]: spec.assign[index[n]] for n in started}
        res = solve_list_schedule(devices, spec.tasks, spec.edges,
                                  bus=spec.topology, pinned=pinned,
                                  ext=ext, clocks=clocks,
                                  seed_assign=spec.assign,
                                  cache=job._solve_cache)
        job._replan_attempts += 1
        if not self._worth_splicing(res, devices, spec, ext, clocks):
            return None   # the re-solve confirms the lock-in
        new_spec = dataclasses.replace(spec, devices=tuple(devices),
                                       assign=tuple(res.assign),
                                       order=tuple(res.order))
        ext_names = {spec.tasks[i].name: v for i, v in ext.items()}
        planned_frontier = new_spec.rebase_partial(clocks, ext=ext_names)
        truth_frontier = new_spec.rebase_partial(clocks, ext=ext_names,
                                                 devices=truth_devs)
        job.replans.append(ReplanRecord(
            at=t_r, straggler=trip, frozen=tuple(started),
            spliced=tuple(pend), spec=new_spec, planned=planned_frontier,
            reason=reason))
        return Timeline(sorted(frozen_events + truth_frontier.events,
                               key=lambda e: (e.start, e.end)))

    def _rescue_device_loss(self, job: StreamJob, name: str,
                            at: float) -> ReplanRecord | None:
        """Frontier-freeze + pinned re-solve of one in-flight job after
        ``name`` departs at stream time ``at`` — the §11 splice with the
        departed device *banned* instead of a straggler re-fit.  Unlike
        the straggler path there is no ``_worth_splicing`` gate: staying
        locked in is not an option once the device is gone."""
        spec = job.final_spec
        if not isinstance(spec, GraphTimelineSpec):
            return None
        dev_names = [d.name for d in spec.devices]
        if name not in dev_names:
            return None
        bi = dev_names.index(name)
        measured = job.measured
        first_start = {t.name: min((e.start for e in measured.events
                                    if e.task == t.name), default=math.inf)
                       for t in spec.tasks}
        started, pend = _ancestor_closed_freeze(
            spec, [t.name for t in spec.tasks
                   if first_start[t.name] < at - 1e-12])
        if not pend:
            return None   # everything had started: nothing left to move
        index = {t.name: i for i, t in enumerate(spec.tasks)}
        if all(spec.assign[index[n]] != bi for n in pend):
            return None   # the frontier never touches the departed device
        started_set = set(started)
        frozen_events = [e for e in measured.events if e.task in started_set]
        # retract by event IDENTITY (task names collide across jobs that
        # share a graph template — same rule as the preemption splice)
        retracted = {id(e) for e in measured.events
                     if e.task not in started_set}
        with self._lock:
            self._virtual_events = [e for e in self._virtual_events
                                    if id(e) not in retracted]
        clocks = carry_clocks(Timeline(frozen_events),
                              job._base_clocks or ClockState())
        if at > clocks.floor:
            # nothing re-issued can start before the loss was detected
            clocks = clocks.with_floor(at)
        devices = list(spec.devices)
        ext = self._frozen_ext(spec, started, Timeline(frozen_events),
                               at, devices, 1.0)
        # Graceful-drain evacuation: a frozen output resident only on the
        # departed device (avail = inf, "never staged") would pin its
        # consumers to a device that no longer exists.  Model the
        # departure notice staging it to the host at the moment of loss
        # (spot-preemption drain) over the device's outbound path; the
        # engine then charges any cross-host consumer the NIC hop as
        # usual.  Drain copies are priced but not given link occupancy —
        # the same simplification as the NIC hop itself (DESIGN.md §16).
        drain_dev = devices[bi]
        lk = spec.topology.link_of(name, "copy_out") \
            if spec.topology is not None else None
        for i, (c_end, avail) in list(ext.items()):
            if spec.assign[i] == bi and math.isinf(avail):
                t = spec.tasks[i]
                bw = drain_dev.copy.bandwidth_bytes_per_s
                if lk is not None and lk.bandwidth_bytes_per_s is not None:
                    bw = min(bw, lk.bandwidth_bytes_per_s)
                dur = 0.0 if (t.out_bytes <= 0.0 or math.isinf(bw)) \
                    else t.out_bytes / bw + drain_dev.copy.latency_s
                ext[i] = (c_end, max(c_end, at) + dur)
        pinned = {index[n]: spec.assign[index[n]] for n in started}
        res = solve_list_schedule(devices, spec.tasks, spec.edges,
                                  bus=spec.topology, pinned=pinned,
                                  ext=ext, clocks=clocks,
                                  max_evals=_REPLAN_MAX_EVALS,
                                  banned=frozenset({bi}),
                                  cache=job._solve_cache)
        new_spec = dataclasses.replace(spec, assign=tuple(res.assign),
                                       order=tuple(res.order))
        ext_names = {spec.tasks[i].name: v for i, v in ext.items()}
        planned_frontier = new_spec.rebase_partial(clocks, ext=ext_names)
        truth_devs = [self.truth(job.uid, d) if self.truth else d
                      for d in new_spec.devices]
        truth_frontier = new_spec.rebase_partial(clocks, ext=ext_names,
                                                 devices=truth_devs)
        rec = ReplanRecord(at=at, straggler=name, frozen=tuple(started),
                           spliced=tuple(pend), spec=new_spec,
                           planned=planned_frontier, reason="device-loss")
        job.replans.append(rec)
        job.measured = Timeline(sorted(
            frozen_events + list(truth_frontier.events),
            key=lambda e: (e.start, e.end)))
        self._meas_clocks = self._next_clocks(
            truth_frontier, carry_clocks(Timeline(frozen_events),
                                         job._base_clocks or ClockState()))
        with self._lock:
            self._virtual_events.extend(truth_frontier.events)
            self._virtual_finishes[job.uid] = job.measured.makespan
        return rec

    # -- threaded execution -------------------------------------------------

    def _execute_threads(self, job: StreamJob) -> None:
        tasks = self._task_factory(job, job.plan)
        order = job.plan.schedule.timeline.link_ticket_order()
        spec = job.plan.schedule.spec
        if isinstance(spec, GraphTimelineSpec):
            # what the straggler monitors compare measured stages against
            job._planned_compute = {
                t.name: spec.devices[a].compute(t.ops)
                for t, a in zip(spec.tasks, spec.assign) if a >= 0}
            job._planned_copy = _planned_copy_map(spec)
        handle = self._core.dispatch(tasks, order, job=f"j{job.uid}")
        job._handle = handle
        handle.add_done_callback(lambda h: self._complete(job, h))
        if self.preempt and job.tenant.qos.tier == TIER_LATENCY:
            # AFTER the latency job's dispatch: its tickets sit at the bus
            # tails now, and each victim's reissue appends BEHIND them
            self._preempt_threaded(job)

    def _preempt_threaded(self, lat: StreamJob) -> None:
        """Threads-mode priority preemption: revoke every running
        batch-tier DAG job's not-yet-started tickets and splice its
        re-solved frontier behind the just-dispatched latency job (§11
        ``reissue``/``rebase_partial`` machinery, reason ``"preempt"``).
        No predicted-gain gate — the point is the ticket ordering, not
        the victim's makespan."""
        with self._lock:
            victims = [j for j in self.jobs
                       if j is not lat and not j.done
                       and j._handle is not None
                       and j.tenant.qos.tier > lat.tenant.qos.tier
                       and j._preempt_attempts < 1]
        for victim in victims:
            self._splice_victim_threaded(victim, lat)

    def _splice_victim_threaded(self, victim: StreamJob,
                                lat: StreamJob) -> None:
        with victim._replan_lock:
            handle = victim._handle
            core = self._core
            if handle is None or core is None or handle.done \
                    or victim._preempt_attempts >= 1:
                return
            spec = victim.final_spec
            if not isinstance(spec, GraphTimelineSpec):
                return
            pending = core.pending_tasks(handle.job)
            started, frontier = _ancestor_closed_freeze(
                spec, [t.name for t in spec.tasks
                       if t.name not in pending])
            pend = set(frontier)
            if not pend:
                return
            victim._preempt_attempts += 1
            ts = self.time_scale
            dyn = victim.tenant.dyn if victim.tenant is not None else None
            devices = dyn.snapshot() if dyn is not None \
                else list(spec.devices)
            now_model = core.now() / ts
            measured = handle.timeline()
            ext = self._frozen_ext(spec, started, measured, now_model,
                                   devices, ts)
            clocks = self._splice_clocks(spec, ext, core.stream_timeline(),
                                         ts)
            if lat.planned is not None:
                # the latency job's planned occupancy: the victim's
                # frontier must price around the tickets now ahead of it
                clocks = clocks.merge(carry_clocks(lat.planned))
            index = {t.name: i for i, t in enumerate(spec.tasks)}
            pinned = {index[n]: spec.assign[index[n]] for n in started}
            res = solve_list_schedule(devices, spec.tasks, spec.edges,
                                      bus=spec.topology, pinned=pinned,
                                      ext=ext, clocks=clocks,
                                      seed_assign=spec.assign,
                                      max_evals=_REPLAN_MAX_EVALS,
                                      cache=victim._solve_cache)
            new_spec = dataclasses.replace(spec, devices=tuple(devices),
                                           assign=tuple(res.assign),
                                           order=tuple(res.order))
            victim._planned_compute = {
                t.name: devices[a].compute(t.ops)
                for t, a in zip(new_spec.tasks, new_spec.assign) if a >= 0}
            victim._planned_copy = _planned_copy_map(new_spec, devices)
            ext_names = {spec.tasks[i].name: v for i, v in ext.items()}
            front_tl = new_spec.rebase_partial(clocks, ext=ext_names)
            sched = dataclasses.replace(victim.plan.schedule,
                                        spec=new_spec, timeline=front_tl)
            plan2 = dataclasses.replace(victim.plan, schedule=sched)
            repl = [t for t in self._task_factory(victim, plan2)
                    if t.task in pend]
            spliced = core.reissue(handle, repl,
                                   front_tl.link_ticket_order())
            victim.replans.append(ReplanRecord(
                at=now_model, straggler=f"j{lat.uid}",
                frozen=tuple(started), spliced=tuple(spliced),
                spec=new_spec, planned=front_tl, reason="preempt"))

    # -- mid-graph re-planning (threads; DESIGN.md §11) ---------------------

    def _on_stream_event(self, jid: str, ev) -> None:
        """StreamCore event hook (runs on device worker threads): feed
        per-task compute measurements into the owning tenant's pump the
        moment they land, and trip the straggler monitor on
        planned-vs-measured slack — compute slack (§11) or copy slack
        (the link-straggler extension: a transfer blowing past its
        planned link occupancy is the same lock-in evidence)."""
        if ev.task is None:
            return
        try:
            uid = int(jid.lstrip("j"))
        except ValueError:
            return
        with self._lock:
            job = self.jobs[uid] if 0 <= uid < len(self.jobs) else None
        if job is None or job.plan is None:
            return
        spec = job.final_spec
        if not isinstance(spec, GraphTimelineSpec):
            return
        pump = job.tenant.pump if job.tenant is not None else None
        if ev.kind == "compute":
            ops = next((float(t.ops) for t in spec.tasks
                        if t.name == ev.task), 0.0)
            if pump is not None and ops > 0.0 and ev.duration > 0.0 \
                    and ev.task not in job._fed_tasks:
                job._fed_tasks.add(ev.task)
                pump.observe(ev.device, ops, ev.duration)
        if not self.replan:
            return
        measured_s = ev.duration / self.time_scale
        if ev.kind == "compute":
            planned_s = job._planned_compute.get(ev.task, 0.0)
            reason = "straggler"
        else:
            planned_s = job._planned_copy.get((ev.task, ev.kind), 0.0)
            reason = "copy-straggler"
        if planned_s <= 0.0 or measured_s <= \
                self.straggler_threshold * planned_s:
            return
        if (ev.task, ev.kind) in job._checked_tasks:
            return   # this stage's slack was already re-solved: lock-in held
        self._replan_threaded(job, ev, reason)

    def _frozen_ext(self, spec: GraphTimelineSpec, started: Sequence[str],
                    measured: Timeline, now_model: float,
                    devices: Sequence[DeviceProfile],
                    time_scale: float) -> dict[int, tuple[float, float]]:
        """(compute_end, avail) per frozen task, in model seconds: measured
        values where the stage already landed, refitted-model estimates for
        the still-running remainder; ``avail = inf`` marks an output that
        never reaches the host (so the re-solve cannot move its consumers
        off-device)."""
        index = {t.name: i for i, t in enumerate(spec.tasks)}
        stage_planned = spec.stage_seconds(devices)
        ext: dict[int, tuple[float, float]] = {}
        for name in started:
            i = index[name]
            a = spec.assign[i]
            if a < 0:
                continue
            t = spec.tasks[i]
            evs = measured.task_events(name)
            comp_ends = [e.end for e in evs if e.kind == "compute"]
            out_ends = [e.end for e in evs if e.kind == "copy_out"]
            if comp_ends:
                c_end = max(comp_ends) / time_scale
            else:   # running: charge the refitted model from now
                c_end = now_model + devices[a].compute(t.ops)
            if out_ends:
                avail = max(out_ends) / time_scale
            elif not _has_copy(devices[a]) or t.out_bytes <= 0.0:
                avail = c_end   # host-resident the moment compute ends
            elif stage_planned.get(name, {}).get("copy_out"):
                # staging planned but not yet measured: estimate
                avail = c_end + stage_planned[name]["copy_out"]
            else:
                avail = math.inf   # never staged: not host-readable
            ext[i] = (c_end, avail)
        return ext

    def _replan_threaded(self, job: StreamJob, ev,
                         reason: str = "straggler") -> None:
        with job._replan_lock:
            if job._replan_attempts >= self.max_replans_per_job:
                return
            handle = job._handle
            core = self._core
            if handle is None or core is None or handle.done:
                return
            spec = job.final_spec
            pending = core.pending_tasks(handle.job)
            started, frontier = _ancestor_closed_freeze(
                spec, [t.name for t in spec.tasks if t.name not in pending])
            pend = set(frontier)
            if len(pend) < self.replan_min_frontier:
                return
            if hasattr(job.workload, "frontier_subgraph"):
                # sanity: the closed snapshot is ancestor-closed by
                # construction; a raise here means the progress view is
                # corrupt
                job.workload.frontier_subgraph(started)
            ts = self.time_scale
            dyn = job.tenant.dyn if job.tenant is not None else None
            devices = dyn.snapshot() if dyn is not None \
                else list(spec.devices)
            now_model = core.now() / ts
            measured = handle.timeline()
            if reason == "copy-straggler":
                # measured wall durations -> model seconds before comparing
                scaled = [dataclasses.replace(e, start=e.start / ts,
                                              end=e.end / ts)
                          for e in measured.events]
                devices = _copy_refit(devices, scaled,
                                      spec.stage_seconds())
            ext = self._frozen_ext(spec, started, measured, now_model,
                                   devices, ts)
            clocks = self._splice_clocks(spec, ext, core.stream_timeline(),
                                         ts)
            index = {t.name: i for i, t in enumerate(spec.tasks)}
            pinned = {index[n]: spec.assign[index[n]] for n in started}
            # the re-solve runs ON the straggler's worker thread — that is
            # deliberate (it freezes the straggler's queue so its successors
            # stay migratable) but means solver latency stalls the splice:
            # cap the descent hard
            res = solve_list_schedule(devices, spec.tasks, spec.edges,
                                      bus=spec.topology, pinned=pinned,
                                      ext=ext, clocks=clocks,
                                      seed_assign=spec.assign,
                                      max_evals=_REPLAN_MAX_EVALS,
                                      cache=job._solve_cache)
            new_spec = dataclasses.replace(spec, devices=tuple(devices),
                                           assign=tuple(res.assign),
                                           order=tuple(res.order))
            if not self._worth_splicing(res, devices, spec, ext, clocks):
                # the re-solve confirms (or barely beats) the lock-in:
                # nothing to splice, and a no-op trigger (e.g.
                # sleep-overhead noise on a tiny task) must NOT burn the
                # job's re-plan budget.  The monitor baseline refreshes
                # from the re-fitted models under the assignment that
                # KEEPS executing — the original one, not the rejected
                # re-solve's.
                job._planned_compute = {
                    t.name: devices[a].compute(t.ops)
                    for t, a in zip(spec.tasks, spec.assign) if a >= 0}
                job._planned_copy = _planned_copy_map(spec, devices)
                job._checked_tasks.add((ev.task, ev.kind))
                return
            job._replan_attempts += 1
            job._planned_compute = {
                t.name: devices[a].compute(t.ops)
                for t, a in zip(new_spec.tasks, new_spec.assign) if a >= 0}
            job._planned_copy = _planned_copy_map(new_spec, devices)
            ext_names = {spec.tasks[i].name: v for i, v in ext.items()}
            frontier = new_spec.rebase_partial(clocks, ext=ext_names)
            sched = dataclasses.replace(job.plan.schedule, spec=new_spec,
                                        timeline=frontier)
            plan2 = dataclasses.replace(job.plan, schedule=sched)
            repl = [t for t in self._task_factory(job, plan2)
                    if t.task in pend]
            spliced = core.reissue(handle, repl,
                                   frontier.link_ticket_order())
            job.replans.append(ReplanRecord(
                at=now_model, straggler=ev.task, frozen=tuple(started),
                spliced=tuple(spliced), spec=new_spec, planned=frontier,
                reason=reason))

    def _worth_splicing(self, res, devices: Sequence[DeviceProfile],
                        spec: GraphTimelineSpec,
                        ext: Mapping[int, tuple[float, float]],
                        clocks: ClockState) -> bool:
        """Splice only for a real predicted gain: the re-solved makespan
        must beat the locked-in assignment re-priced under the SAME
        re-fitted models, frozen ext times, and carried clocks — and under
        its OWN planned order (that is what keeps executing if the splice
        is rejected)."""
        if tuple(res.assign) == tuple(spec.assign):
            return False
        seed_mk = max(graph_finish_times(devices, spec.tasks, spec.edges,
                                         spec.assign, topology=spec.topology,
                                         order=spec.order, clocks=clocks,
                                         ext=ext))
        return res.makespan * _REPLAN_MIN_GAIN < seed_mk

    def _splice_clocks(self, spec: GraphTimelineSpec,
                       ext: Mapping[int, tuple[float, float]],
                       stream: Timeline, time_scale: float) -> ClockState:
        """Where each link/device clock stands for the frontier re-pricing:
        the measured stream so far, floored by the frozen tasks' estimated
        tails (their pending copy_outs stay ahead of re-issued tickets on
        each link; a running compute holds its device)."""
        base = carry_clocks(stream)
        links = {k: v / time_scale for k, v in base.links.items()}
        devs = {k: v / time_scale for k, v in base.devices.items()}
        for i, (c_end, avail) in ext.items():
            a = spec.assign[i]
            if a < 0:
                continue
            dname = spec.devices[a].name
            devs[dname] = max(devs.get(dname, 0.0), c_end)
            if math.isfinite(avail) and avail > c_end:
                lk = spec.topology.link_of(dname, "out")
                if lk is not None:
                    links[lk.name] = max(links.get(lk.name, 0.0), avail)
        return ClockState(links=links, devices=devs)

    def _complete(self, job: StreamJob, handle) -> None:
        # Runs as a JobHandle done-callback on a device worker thread: it
        # must ALWAYS complete the job and free the in-flight slot, or one
        # bad observation (pump -> observe -> refit listeners) would wedge
        # the planner and every later job on that device.
        try:
            job.measured = handle.timeline()
            if handle.errors:
                job.error = handle.errors[0]
            else:
                self._feed(job)
        except BaseException as exc:
            if job.error is None:
                job.error = exc
        finally:
            job._done.set()
            self._inflight.release()

    def _feed(self, job: StreamJob) -> None:
        pump = job.tenant.pump if job.tenant is not None else None
        if pump is None or job.measured is None:
            return
        spec = job.final_spec
        if spec is None:
            return
        if isinstance(spec, GraphTimelineSpec):
            # DAG jobs observe per task (many sizes per device per job);
            # tasks already fed during execution (the straggler monitor's
            # early feed) are skipped, not observed twice
            rows = [r for r in spec.task_ops()
                    if r[0] not in job._fed_tasks]
            pump.feed_tasks(job.measured, rows)
        else:
            pump.feed(job.measured, spec.ops_by_device())


# ---------------------------------------------------------------------------
# Cross-plan invariant checks (tests + BENCH_streaming acceptance)
# ---------------------------------------------------------------------------


def _planned_link_order(j: StreamJob) -> dict[str, list[tuple]]:
    """The per-link grant order the job was *actually* issued under: the
    original plan's order for tickets never re-issued, then — for each
    mid-graph re-plan, in splice order — the frontier's re-planned order
    for the tasks that replan owns (the last splice of a task wins, exactly
    as the live buses saw it)."""
    planned = j.plan.schedule.timeline.link_ticket_order()
    if not j.replans:
        return planned
    owner: dict[str, int] = {}
    for idx, r in enumerate(j.replans):
        for name in r.spliced:
            owner[name] = idx
    out = {link: [t for t in seq
                  if not (len(t) == 3 and t[0] in owner)]
           for link, seq in planned.items()}
    for idx, r in enumerate(j.replans):
        for link, seq in r.planned.link_ticket_order().items():
            out.setdefault(link, []).extend(
                t for t in seq if owner.get(t[0]) == idx)
    return out


def verify_stream_invariants(jobs: Sequence[StreamJob], *,
                             eps: float = 1e-9) -> list[str]:
    """The Fig. 2 invariants, across plan boundaries.  Returns violations
    (empty = pass):

    * per link, ALL jobs' transfers serialize (no two copy events overlap,
      even from different plans);
    * per job and device, compute chunk j starts only after input chunk j
      landed, and output chunk j only after compute chunk j;
    * per job and link, the measured grant order equals the planned
      priority/ticket order — for a mid-graph re-planned job, the splice of
      the original order (frozen tasks) with each re-plan's frontier order.
    """
    problems: list[str] = []
    done = [j for j in jobs if j.measured is not None and j.error is None]

    # per-link serialization across the whole stream
    by_link: dict[str, list] = {}
    for j in done:
        for e in j.measured.events:
            if e.kind != "compute" and e.link is not None:
                by_link.setdefault(e.link, []).append(e)
    for link, evs in by_link.items():
        evs.sort(key=lambda e: (e.start, e.end))
        for a, b in zip(evs, evs[1:]):
            if b.start < a.end - eps:
                problems.append(
                    f"link {link}: {b.device}/{b.kind} starts {a.end - b.start:.3g}s "
                    f"before {a.device}/{a.kind} ends")

    for j in done:
        # copy-before-compute-before-copy-out, chunk-wise; task-graph
        # timelines group per (device, task) — a device runs many tasks
        for name, task in {(e.device, e.task) for e in j.measured.events}:
            evs = [e for e in j.measured.device_events(name)
                   if e.task == task]
            ins = sorted((e for e in evs if e.kind == "copy_in"),
                         key=lambda e: e.chunk)
            comps = sorted((e for e in evs if e.kind == "compute"),
                           key=lambda e: e.chunk)
            outs = sorted((e for e in evs if e.kind == "copy_out"),
                          key=lambda e: e.chunk)
            if task is not None:
                # DAG tasks: every input copy (external + edge reads) must
                # land before the single compute starts
                for i_ev in ins:
                    if comps and comps[0].start < i_ev.end - eps:
                        problems.append(
                            f"job {j.uid} {name}/{task}: compute before "
                            f"input copy {i_ev.chunk} landed")
                # EVERY output event must start after compute ends — the
                # old zip(comps[-1:], outs) paired only the first output
                # with the last compute, silently skipping the rest
                if comps:
                    c_end = comps[-1].end
                    for o_ev in outs:
                        if o_ev.start < c_end - eps:
                            problems.append(f"job {j.uid} {name}/{task}: "
                                            "copy_out before compute ended")
                continue
            for i_ev, c_ev in zip(ins, comps):
                if c_ev.start < i_ev.end - eps:
                    problems.append(f"job {j.uid} {name}: compute chunk "
                                    f"{c_ev.chunk} before its input landed")
            for c_ev, o_ev in zip(comps, outs):
                if o_ev.start < c_ev.end - eps:
                    problems.append(f"job {j.uid} {name}: copy_out chunk "
                                    f"{o_ev.chunk} before its compute ended")
        # planned per-link grant order is replayed (splice-aware)
        if j.plan is None:
            continue
        planned = _planned_link_order(j)
        measured = j.measured.link_ticket_order()
        for link, want in planned.items():
            got = measured.get(link, [])
            got_set = set(got)   # hoisted: one set, not one per element
            want = [t for t in want if t in got_set]   # subset task lists
            if got != want:
                problems.append(f"job {j.uid} link {link}: grant order "
                                f"{got} != planned {want}")
    return problems
