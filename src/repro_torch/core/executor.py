"""Overlapped co-execution — the threaded half of the streaming runtime.

The unified bus engine (``core.bus``, Fig. 2) *models* the schedule: copies
serialized per link in priority order, each device computing as soon as its
inputs land (overlapping other devices' copies).  This module *executes*
it, and it does so as a **stream**: ``StreamCore`` owns one
long-lived worker thread per device and one ticketed lock per topology
link, both of which survive across plans — each dispatched plan appends its
per-link grant sequence to the live buses, so plan k+1's input copies are
granted as soon as plan k's transfers drain a link, while plan k's tail is
still computing (DESIGN.md §9).  Compute never takes a link, so device A's
compute overlaps device B's copies — the overlap the paper's co-execution
speedup comes from; copies on *different* links proceed concurrently
(DESIGN.md §4).

``OverlappedExecutor`` is the one-shot facade kept for single-plan callers
(``HGemms.execute`` and the one-shot test surface): it spins up a private
``StreamCore``, dispatches the one plan, waits, and shuts the core down.

Measured wall-clock intervals are recorded per stage as ``Timeline``s of
``BusEvent``s — per job *and* for the whole stream — so the same invariant
checks (per-link serialization, priority order, compute-after-copy) apply
to a real run, to a whole job stream across plan boundaries, and to the
simulation.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Mapping, Sequence

from .bus import BusEvent, Timeline
from .device_model import DeviceProfile


@dataclasses.dataclass
class DeviceTask:
    """One device's three stages.  ``None`` stages are skipped (no-copy
    devices such as the host CPU compute in place).

    Pipelined form: when ``compute_chunks`` is set, the per-chunk callables
    replace the whole-stage ones and the executor streams them — the input
    chunks run back-to-back under one bus ticket (the engine schedules a
    device's chunks contiguously on its link) while a consumer thread
    computes chunk j as soon as chunk j has landed, which is the real
    copy/compute overlap the chunked timeline prices.  Output chunks run
    after compute under the copy_out ticket.

    Task-graph form (DESIGN.md §10): ``task`` names the DAG task this
    stage group runs (a device may run many tasks per job, each its own
    ``DeviceTask``), and ``deps`` lists upstream task names — the worker
    blocks on their completion events before starting any stage, so a task
    never begins before every upstream task's outputs have landed, while
    tickets still serialize the links in the engine's planned order."""

    device: str
    copy_in: Callable[[], None] | None
    compute: Callable[[], None] | None
    copy_out: Callable[[], None] | None
    copy_in_chunks: Sequence[Callable[[], None]] | None = None
    compute_chunks: Sequence[Callable[[], None]] | None = None
    copy_out_chunks: Sequence[Callable[[], None]] | None = None
    task: str | None = None
    deps: tuple[str, ...] = ()

    @property
    def pipelined(self) -> bool:
        return bool(self.compute_chunks)

    def has_copy_in(self) -> bool:
        return self.copy_in is not None or bool(self.copy_in_chunks)

    def has_copy_out(self) -> bool:
        return self.copy_out is not None or bool(self.copy_out_chunks)

    def ticket(self, kind: str) -> tuple:
        """The engine's ticket for one of this task's stages —
        ``(device, kind)`` for divisible plans, ``(task, device, kind)``
        for task-graph plans (matches ``Timeline._copy_tickets``)."""
        base = (self.device, kind)
        return base if self.task is None else (self.task,) + base


class TicketBus:
    """Shared bus granting exclusive access in a fixed ticket order.

    Tickets are hashable tuples — ``(device, kind)`` for one-shot plans,
    ``(job, device, kind)`` in the streaming runtime; the grant sequence is
    derived from the planned timeline, so the measured run serializes
    transfers in the same priority order the optimizer assumed.  ``extend``
    appends a later plan's tickets while earlier ones are still draining —
    this is what lets the bus survive across plans.
    """

    def __init__(self, sequence: Sequence[tuple] = ()):
        self._seq = list(sequence)
        self._pos = 0
        self._cv = threading.Condition()

    def extend(self, sequence: Sequence[tuple]) -> None:
        """Append a later plan's grant sequence (streaming runtime)."""
        with self._cv:
            self._seq.extend(sequence)
            self._cv.notify_all()

    def acquire(self, ticket: tuple, *, append_timeout: float = 1.0) -> None:
        with self._cv:
            if ticket not in self._seq:
                # a concurrent dispatch/reissue may be mid-extend: its worker
                # closures can reach acquire before the grant sequence lands
                # on this bus.  Wait (bounded) for the ticket to appear
                # instead of raising on the benign race.
                if not self._cv.wait_for(lambda: ticket in self._seq,
                                         timeout=append_timeout):
                    raise ValueError(f"ticket {ticket} not in bus schedule")
            self._cv.wait_for(
                lambda: self._pos < len(self._seq)
                and self._seq[self._pos] == ticket)

    def release(self, ticket: tuple) -> None:
        with self._cv:
            # explicit check, not assert: the grant-head invariant must
            # survive `python -O` (a silent out-of-order release would let
            # two transfers share the link and corrupt every measured
            # timeline downstream)
            if self._pos >= len(self._seq) or self._seq[self._pos] != ticket:
                raise RuntimeError(
                    f"out-of-order release: {ticket} is not the grant head "
                    f"(pending={self._seq[self._pos:]!r})")
            self._pos += 1
            # prune the granted prefix: a persistent bus on a sustained
            # stream must not retain every historical ticket (and acquire's
            # membership scan must stay O(pending), not O(all history))
            del self._seq[:self._pos]
            self._pos = 0
            self._cv.notify_all()

    def cancel(self, pred: Callable[[tuple], bool]) -> None:
        """Drop pending tickets matching ``pred`` so the bus never stalls
        behind stages that will no longer run (crashed device, failed job)."""
        with self._cv:
            self._seq[self._pos:] = [t for t in self._seq[self._pos:]
                                     if not pred(t)]
            self._cv.notify_all()

    def cancel_device(self, device: str) -> None:
        """Drop a crashed device's pending tickets (any job)."""
        self.cancel(lambda t: t[-2] == device)

    def retain(self, tickets: set[tuple]) -> None:
        """Keep only the given pending tickets (callers may legitimately run
        a subset of the planned devices; unclaimed tickets must not wedge
        the grant sequence)."""
        self.cancel(lambda t: t not in tickets)

    def depth(self) -> int:
        """Pending (not-yet-granted) tickets — the admission-control queue
        depth signal (DESIGN.md §13)."""
        with self._cv:
            return len(self._seq) - self._pos


# ---------------------------------------------------------------------------
# The persistent streaming core
# ---------------------------------------------------------------------------


class JobHandle:
    """Completion handle for one dispatched plan: its measured events, its
    error (if any), and a done event / callback hook."""

    def __init__(self, job: str, devices: int):
        self.job = job
        self.events: list[BusEvent] = []
        self.errors: list[BaseException] = []
        self._remaining = devices
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._callbacks: list[Callable[["JobHandle"], None]] = []
        if devices == 0:   # a plan may assign every op to devices the task
            self._done.set()   # list doesn't cover; nothing will ever run

    def _device_done(self) -> None:
        with self._lock:
            self._remaining -= 1
            if self._remaining > 0:
                return
            callbacks = list(self._callbacks)
        # callbacks run BEFORE the done event (wait() must observe their
        # errors) and never propagate: _device_done runs on a persistent
        # device worker thread, and a raising callback would kill it —
        # hanging every later job queued on that device
        for fn in callbacks:
            self._run_callback(fn)
        self._done.set()

    def _run_callback(self, fn: Callable[["JobHandle"], None]) -> None:
        try:
            fn(self)
        except BaseException as exc:
            with self._lock:
                self.errors.append(exc)

    def add_done_callback(self, fn: Callable[["JobHandle"], None]) -> None:
        with self._lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> Timeline:
        """Block until every device finished its stages; raise the first
        stage error; return the job's measured timeline."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"job {self.job!r} still running")
        if self.errors:
            raise self.errors[0]
        return self.timeline()

    def timeline(self) -> Timeline:
        with self._lock:
            events = list(self.events)
        return Timeline(sorted(events, key=lambda e: (e.start, e.end)))


class _TaskDone:
    """Completion latch for one (job, task): set when the task's stage
    group finished (``ok`` records whether it succeeded)."""

    __slots__ = ("event", "ok")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.ok = False


class _DeviceWorker(threading.Thread):
    """One long-lived worker per device: runs dispatched stage groups
    strictly in dispatch order (a device executes one plan at a time)."""

    def __init__(self, device: str):
        super().__init__(name=f"poas-dev-{device}", daemon=True)
        self.device = device
        self.q: queue.SimpleQueue = queue.SimpleQueue()
        self.start()

    def run(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                return
            item()  # closures handle their own errors


class StreamCore:
    """Long-lived per-device worker threads + per-link ticket buses that
    survive across plans — the persistent half of ``CoExecutionRuntime``.

    ``dispatch`` is non-blocking: it appends the plan's tickets to the live
    buses and enqueues each device's stage group on that device's worker, so
    back-to-back plans overlap (plan k+1's copies start the moment plan k
    drains each link, per-device order preserved by the worker queues).  All
    measured events share one time origin (core creation), so the stream
    timeline is one coherent axis across plan boundaries.
    """

    def __init__(self) -> None:
        self._workers: dict[str, _DeviceWorker] = {}
        self._buses: dict[str, TicketBus] = {}
        self._lock = threading.Lock()
        # the stream record: every job's measured events on one time axis.
        # This is the observable product (stream_timeline / cross-plan
        # invariant checks) and grows with the stream; long-lived callers
        # that don't need the full history can snapshot and reset it.
        self._events: list[BusEvent] = []
        # per-(job, task) completion: cross-device dependency waits for
        # task-graph plans (entries dropped when the job completes)
        self._task_done: dict[tuple[str, str], "_TaskDone"] = {}
        # per-(job, task) [incarnation, status] for named tasks.  status is
        # "pending" until the stage group begins, then "started"; a
        # mid-graph reissue bumps the incarnation of still-pending tasks,
        # turning their already-enqueued closures into no-ops (a SimpleQueue
        # entry cannot be removed) while the replacement closures — carrying
        # the new incarnation — run on their new devices.
        self._task_state: dict[tuple[str, str], list] = {}
        # optional observer: called with (job id, event) after every
        # measured stage lands — the runtime's straggler monitor and
        # during-execution observation feed hang off this (DESIGN.md §11).
        self.on_event: Callable[[str, BusEvent], None] | None = None
        self._jobs = 0
        self._closed = False
        # serializes ticket admission (bus extends + worker enqueues) across
        # dispatch and reissue: without it a concurrent dispatch could land
        # between a reissue's bus-extend and its worker-enqueue, inverting
        # the two jobs' relative order on a shared link vs. a shared device
        # queue — a permanent deadlock (the grant head would sit behind its
        # own waiter).  Always acquired before self._lock, never after.
        self._admit = threading.Lock()
        self._t0 = time.perf_counter()

    # -- plumbing -----------------------------------------------------------

    def _worker(self, device: str) -> _DeviceWorker:
        with self._lock:
            w = self._workers.get(device)
            if w is None:
                w = self._workers[device] = _DeviceWorker(device)
            return w

    def _bus(self, link: str) -> TicketBus:
        with self._lock:
            b = self._buses.get(link)
            if b is None:
                b = self._buses[link] = TicketBus()
            return b

    def _record(self, handle: JobHandle, device: str, kind: str, link: str | None,
                start: float, end: float, chunk: int = 0,
                task: str | None = None) -> None:
        ev = BusEvent(device, kind, start, end, link, chunk, task)
        with self._lock:
            self._events.append(ev)
        with handle._lock:
            handle.events.append(ev)
        cb = self.on_event
        if cb is not None:
            try:
                cb(handle.job, ev)
            except BaseException as exc:
                # observers run on device worker / pipeline threads: a
                # raising monitor must fail the job, never kill the worker
                with handle._lock:
                    handle.errors.append(exc)

    def now(self) -> float:
        """Current stream time (seconds since core creation) — the axis
        every measured event is stamped on."""
        return time.perf_counter() - self._t0

    def stream_timeline(self, *, reset: bool = False) -> Timeline:
        """Every measured event of every job, one time axis — what the
        cross-plan invariant checks run on.  ``reset=True`` hands the
        record over and clears it (long-lived streams that checkpoint
        their history instead of holding it forever)."""
        with self._lock:
            events = list(self._events)
            if reset:
                self._events.clear()
        return Timeline(sorted(events, key=lambda e: (e.start, e.end)))

    def link_depths(self) -> dict[str, int]:
        """Pending-ticket depth per live bus — what the multi-tenant
        admission controller inspects before pricing a deadline
        (DESIGN.md §13).  HTS-style admission works at queue depth, not
        at job completion granularity."""
        with self._lock:
            buses = dict(self._buses)
        return {name: bus.depth() for name, bus in buses.items()}

    def shutdown(self) -> None:
        """Stop the worker threads after their queues drain."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            workers = list(self._workers.values())
        for w in workers:
            w.q.put(None)
        for w in workers:
            w.join(timeout=30)

    # -- dispatch -----------------------------------------------------------

    def dispatch(self, tasks: Sequence[DeviceTask],
                 link_order: Mapping[str, Sequence[tuple]],
                 *, job: str | None = None) -> JobHandle:
        """Admit one plan: ``link_order`` is the engine's per-link grant
        order (``Timeline.link_ticket_order``); tickets for stages the task
        list does not provide are skipped up front so they can never wedge
        a bus.  Task-graph plans name their tasks (``DeviceTask.task``):
        each gets a per-job completion latch, and a task with ``deps``
        blocks on its upstream latches before running any stage.  Returns
        immediately with a ``JobHandle``."""
        with self._lock:
            if self._closed:
                raise RuntimeError("StreamCore is shut down")
            jid = job if job is not None else f"job{self._jobs}"
            self._jobs += 1
        named: list[tuple[str, str]] = []
        for t in tasks:
            if t.compute is None and not t.compute_chunks:
                raise ValueError(f"task {t.device!r} has neither compute "
                                 "nor compute_chunks")
            if t.task is not None:
                named.append((jid, t.task))
        handle = JobHandle(jid, len(tasks))
        if named:
            with self._lock:
                for key in named:
                    self._task_done[key] = _TaskDone()
                    self._task_state[key] = [0, "pending"]
            # all of a job's latches are released together when the job
            # completes (dep waits are intra-job, so this is the earliest
            # safe point) — the registry must not grow with the stream
            handle.add_done_callback(lambda h: self._drop_latches(named))
        with self._admit:
            ticket_link = self._admit_tickets(jid, tasks, link_order)
            for t in tasks:
                self._worker(t.device).q.put(
                    lambda t=t: self._run_task(handle, jid, t, ticket_link))
        return handle

    def _admit_tickets(self, jid: str, tasks: Sequence[DeviceTask],
                       link_order: Mapping[str, Sequence[tuple]]
                       ) -> dict[tuple, str]:
        """Extend the buses with a plan's per-link grant order, filtered to
        the stages the task list actually provides (an unclaimed ticket
        would wedge its link).  Returns ticket -> link for the stage
        closures.  Shared by dispatch and reissue; callers hold
        ``self._admit``."""
        provided: set[tuple] = set()
        for t in tasks:
            if t.has_copy_in():
                provided.add(t.ticket("copy_in"))
            if t.has_copy_out():
                provided.add(t.ticket("copy_out"))
        ticket_link: dict[tuple, str] = {}
        for link, seq in link_order.items():
            kept = []
            for tk in seq:
                tk = tuple(tk)
                if tk in provided:
                    kept.append((jid,) + tk)
                    ticket_link[tk] = link
            if kept:
                self._bus(link).extend(kept)
        return ticket_link

    def _drop_latches(self, keys: Sequence[tuple[str, str]]) -> None:
        with self._lock:
            for key in keys:
                self._task_done.pop(key, None)
                self._task_state.pop(key, None)

    # -- mid-graph re-planning (DESIGN.md §11) ------------------------------

    def pending_tasks(self, jid: str) -> set[str]:
        """Names of the job's not-yet-started (hence migratable) named
        tasks.  A task counts as started the moment its stage group begins
        — including a group still blocked on upstream latches or a ticket
        grant — because its worker thread is already committed to it."""
        with self._lock:
            return {name for (j, name), st in self._task_state.items()
                    if j == jid and st[1] == "pending"}

    def reissue(self, handle: JobHandle, tasks: Sequence[DeviceTask],
                link_order: Mapping[str, Sequence[tuple]]) -> tuple[str, ...]:
        """Splice a mid-graph re-plan into a live job: atomically revoke the
        given tasks' not-yet-started incarnations (their queued closures
        become no-ops, their pending tickets are dropped from every bus) and
        re-dispatch the replacements — new devices, new per-link grant order
        (``link_order`` from the re-planned frontier timeline's
        ``link_ticket_order``).  New tickets are appended at each bus's
        tail, so the splice behaves exactly like a fresh dispatch and the
        streaming deadlock-freedom argument applies unchanged: granted
        prefixes and the frozen tasks' pending tickets are never disturbed.

        Returns the task names actually spliced.  A task that started
        between the caller's ``pending_tasks`` snapshot and this call keeps
        its original placement and tickets; its replacement is discarded.
        """
        jid = handle.job
        by_name: dict[str, DeviceTask] = {}
        for t in tasks:
            if t.task is None:
                raise ValueError("reissue needs named (task-graph) stage "
                                 "groups")
            by_name[t.task] = t
        new_inc: dict[str, int] = {}
        with self._lock:
            if self._closed:
                raise RuntimeError("StreamCore is shut down")
            spliced = [name for name in by_name
                       if self._task_state.get((jid, name),
                                               (0, "started"))[1]
                       == "pending"]
            # top up the handle BEFORE bumping incarnations: a stale
            # closure dequeued right after the bump calls _device_done
            # immediately, and the job must not complete early
            with handle._lock:
                handle._remaining += len(spliced)
            for name in spliced:
                st = self._task_state[(jid, name)]
                st[0] += 1
                new_inc[name] = st[0]
            buses = list(self._buses.values())
        if not spliced:
            return ()
        spliced_set = set(spliced)
        repl = [t for t in tasks if t.task in spliced_set]
        # the whole splice (ticket drop + re-admission + enqueue) happens
        # under the admission lock: a dispatch landing in between would
        # invert the two jobs' relative order on a shared link vs. a
        # shared device queue — a deadlock
        with self._admit:
            for bus in buses:
                bus.cancel(lambda t: t[0] == jid and len(t) == 4
                           and t[1] in spliced_set)
            ticket_link = self._admit_tickets(jid, repl, link_order)
            # enqueue in the caller's order (the re-planned spec's
            # topological order) — a same-device dependency queued out of
            # order would deadlock the device worker on its own queue
            for t in repl:
                self._worker(t.device).q.put(
                    lambda t=t, inc=new_inc[t.task]:
                        self._run_task(handle, jid, t, ticket_link, inc))
        return tuple(t.task for t in repl)

    def _await_deps(self, jid: str, task: DeviceTask) -> None:
        """Block until every upstream task's stage group completed; raise
        if one failed (the data this task needs never landed).  Deps not in
        the registry are treated as satisfied — callers may legitimately
        dispatch a subset of the planned tasks."""
        for dep in task.deps:
            with self._lock:
                latch = self._task_done.get((jid, dep))
            if latch is None:
                continue
            latch.event.wait()
            if not latch.ok:
                raise RuntimeError(f"upstream task {dep!r} failed; "
                                   f"{task.task!r} cannot run")

    def run(self, tasks: Sequence[DeviceTask],
            link_order: Mapping[str, Sequence[tuple]],
            *, job: str | None = None) -> Timeline:
        """Dispatch one plan and block for its measured timeline."""
        return self.dispatch(tasks, link_order, job=job).wait()

    # -- per-device stage groups -------------------------------------------

    def _acquire(self, jid: str, task: DeviceTask, kind: str,
                 ticket_link: Mapping[tuple, str]) -> tuple[TicketBus, tuple]:
        base = task.ticket(kind)
        link = ticket_link.get(base)
        if link is None:
            raise ValueError(f"ticket {base} not in bus schedule")
        bus = self._bus(link)
        ticket = (jid,) + base
        bus.acquire(ticket)
        return bus, ticket

    def _run_task(self, handle: JobHandle, jid: str, task: DeviceTask,
                  ticket_link: Mapping[tuple, str], inc: int = 0) -> None:
        latch = None
        if task.task is not None:
            with self._lock:
                st = self._task_state.get((jid, task.task))
                if st is not None and st[0] != inc:
                    # superseded by a mid-graph reissue: the replacement
                    # closure owns this task now.  This stale stage group
                    # is a no-op — but it still counts toward the handle,
                    # which was topped up at reissue time.
                    handle._device_done()
                    return
                if st is not None:
                    st[1] = "started"
                latch = self._task_done.get((jid, task.task))
        try:
            self._await_deps(jid, task)
            if task.pipelined:
                self._run_pipelined(handle, jid, task, ticket_link)
            else:
                self._run_staged(handle, jid, task, ticket_link)
            if latch is not None:
                latch.ok = True
        except BaseException as exc:  # surfaced via handle.wait()
            # drop the failed stage group's remaining tickets on every bus
            # so no grant sequence wedges; later jobs' tickets stay (the
            # worker thread survives).  Divisible plans have one stage
            # group per device; graph plans cancel per task — sibling
            # tasks on the device still run (a downstream task that needed
            # this one fails its own dependency wait and cancels itself).
            if task.task is None:
                pred = lambda t: t[0] == jid and t[-2] == task.device
            else:
                pred = lambda t: (t[0] == jid and len(t) == 4
                                  and t[1] == task.task)
            with self._lock:
                buses = list(self._buses.values())
            for bus in buses:
                bus.cancel(pred)
            with handle._lock:
                handle.errors.append(exc)
        finally:
            if latch is not None:
                latch.event.set()   # downstream waiters see ok=False on error
            handle._device_done()

    def _run_staged(self, handle: JobHandle, jid: str, task: DeviceTask,
                    ticket_link: Mapping[tuple, str]) -> None:
        def stage(kind: str, fn: Callable[[], None], on_bus: bool) -> None:
            bus = ticket = None
            if on_bus:
                bus, ticket = self._acquire(jid, task, kind, ticket_link)
            start = time.perf_counter() - self._t0
            try:
                fn()
            finally:
                # stamp the end BEFORE releasing the bus: the next holder may
                # start immediately, and measured bus events must not overlap
                end = time.perf_counter() - self._t0
                if bus is not None:
                    bus.release(ticket)
            self._record(handle, task.device, kind,
                         ticket_link.get(task.ticket(kind)), start, end,
                         task=task.task)

        if task.copy_in is not None:
            stage("copy_in", task.copy_in, on_bus=True)
        stage("compute", task.compute, on_bus=False)
        if task.copy_out is not None:
            stage("copy_out", task.copy_out, on_bus=True)

    def _run_pipelined(self, handle: JobHandle, jid: str, task: DeviceTask,
                       ticket_link: Mapping[tuple, str]) -> None:
        """Stream the chunked stages exactly as the engine prices them:
        the copy feeder holds the copy_in ticket across its chunks (the
        engine schedules them contiguously on the link) while the
        consumer thread computes chunk j as soon as it lands, and the
        output loop copies chunk j out as soon as chunk j is computed —
        overlapping the remaining compute chunks, like the engine's
        ``max(link_clock, compute_chunk_end)`` out-chunk starts."""
        dev = task.device
        t0 = self._t0
        in_chunks = list(task.copy_in_chunks or ())
        comp_chunks = list(task.compute_chunks or ())
        out_chunks = list(task.copy_out_chunks or ())
        landed = threading.Semaphore(0)     # input chunk j copied
        computed = threading.Semaphore(0)   # compute chunk j finished
        aborted = threading.Event()
        consumer_errs: list[BaseException] = []

        def consume() -> None:
            try:
                for j, fn in enumerate(comp_chunks):
                    if in_chunks:
                        landed.acquire()
                        if aborted.is_set():
                            return
                    start = time.perf_counter() - t0
                    fn()
                    self._record(handle, dev, "compute", None, start,
                                 time.perf_counter() - t0, chunk=j,
                                 task=task.task)
                    computed.release()
            except BaseException as exc:
                consumer_errs.append(exc)
            finally:
                # on early exit, unblock an output loop waiting on
                # chunks that will never be computed (it re-checks
                # consumer_errs / aborted after each acquire)
                for _ in out_chunks:
                    computed.release()

        consumer = threading.Thread(target=consume, daemon=True)
        if in_chunks:
            bus, ticket = self._acquire(jid, task, "copy_in", ticket_link)
            consumer.start()
            try:
                for j, fn in enumerate(in_chunks):
                    start = time.perf_counter() - t0
                    fn()
                    self._record(handle, dev, "copy_in",
                                 ticket_link.get(task.ticket("copy_in")),
                                 start, time.perf_counter() - t0, chunk=j,
                                 task=task.task)
                    landed.release()
            except BaseException:
                # unblock the consumer before surfacing the error
                aborted.set()
                landed.release()
                raise
            finally:
                bus.release(ticket)
        else:
            consumer.start()
        if out_chunks:
            bus, ticket = self._acquire(jid, task, "copy_out", ticket_link)
            try:
                for j, fn in enumerate(out_chunks):
                    computed.acquire()   # chunk j's matmul is done
                    if consumer_errs or aborted.is_set():
                        break
                    start = time.perf_counter() - t0
                    fn()
                    self._record(handle, dev, "copy_out",
                                 ticket_link.get(task.ticket("copy_out")),
                                 start, time.perf_counter() - t0, chunk=j,
                                 task=task.task)
            finally:
                bus.release(ticket)
        consumer.join()
        if consumer_errs:
            raise consumer_errs[0]


# ---------------------------------------------------------------------------
# One-shot facade (single-plan callers)
# ---------------------------------------------------------------------------


class OverlappedExecutor:
    """Thin one-shot facade over ``StreamCore``: executes a single planned
    timeline with a private core, then shuts it down.

    ``run`` returns the *measured* timeline.  Stage durations are whatever
    the callables really take; the planned timeline only fixes each link's
    grant order, exactly as the paper's runtime does.
    """

    def __init__(self, devices: Sequence[DeviceProfile], planned: Timeline):
        self.devices = list(devices)
        self.planned = planned

    @staticmethod
    def link_sequences(planned: Timeline) -> dict[str, list[tuple[str, str]]]:
        """Per-link grant order of (device, kind) tickets, straight from the
        engine's timeline (chunk events collapse to one ticket; events with
        no link tag — e.g. measured timelines — share a single 'bus')."""
        return planned.link_ticket_order()

    @staticmethod
    def bus_sequence(planned: Timeline) -> list[tuple[str, str]]:
        """Flat grant order across all links (``Timeline.ticket_order``).
        Kept for single-bus callers; ``link_sequences`` is the per-link
        truth."""
        return planned.ticket_order()

    def run(self, tasks: Sequence[DeviceTask]) -> Timeline:
        core = StreamCore()
        try:
            return core.run(tasks, self.planned.link_ticket_order())
        finally:
            core.shutdown()
