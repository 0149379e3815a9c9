"""The shared-bus timeline engine — ONE source of truth for solve/simulate/execute.

The paper's co-execution speedup lives on the Fig. 2 timeline: input copies
serialized on the host bus in priority order, compute overlapping other
devices' copies, output copies serialized after compute.  Historically the
repo carried three independent implementations of that timeline (the
optimizer's finish-time model, ``simulate_timeline``, and the overlapped
executor's bus order) which measurably disagreed; this module replaces all
of them with a single event-graph builder (DESIGN.md §4).

Two generalizations over the paper:

* ``BusTopology`` — named serialization ``Link``s with optional bandwidth
  caps; each device maps its copy_in/copy_out to a link (or to none — the
  host CPU computes in place).  The paper's single serialized PCIe bus,
  fully independent per-device links, and mixed topologies (CPU no-copy +
  two GPUs sharing PCIe + a TPU group on its own ICI feed) are all
  instances of the same engine.
* **Chunked pipelined copies** — a device with ``pipeline_chunks = C > 1``
  splits the per-op part of its input copy into C chunks so compute on
  chunk 1 overlaps the transfer of chunk 2 (the overlap the paper leaves as
  future work).  The shared operand (the full B panel for GEMM — the
  c-independent part of the copy) still lands before the first compute
  chunk; per-chunk launch overhead is charged by evaluating the compute
  model at ``c/C`` per chunk and paying the copy launch latency once per
  transfer, so over-chunking is priced, not free.
  Chunks are priced equal-sized; the adapt phase's grain-rounded
  ``chunk_rows`` are near-equal, and callers pass the *adapted* chunk
  count (``len(chunk_rows)``) so a device capped below its nominal
  ``pipeline_chunks`` by the alignment grain is never charged for chunks
  that don't exist.

``build_timeline`` emits the event graph; ``engine_finish_times`` runs the
same control flow without materializing events (the optimizer's feasibility
check calls it thousands of times per solve).

A third generalization backs the streaming runtime (DESIGN.md §9): a
timeline may start from **carried-over clocks** (``ClockState``) instead of
t = 0, so plan k+1's input copies queue behind plan k's tail on each link
while its devices wait only for their *own* previous work — back-to-back
plans overlap exactly the way a single plan's devices do.

A fourth generalization backs task-graph workloads (DESIGN.md §10): the
same clocks also price **precedence-constrained DAGs**
(``build_graph_timeline`` / ``graph_finish_times``), where an event may
depend on another event's finish, not just its device/link clock — a
cross-device dependency edge becomes link copies (producer staged to host
once, each consumer reading over its own in-link), a same-device edge is
free.  Events carry the owning task's name, so the executor's per-link
ticket order, the invariant checks, and the per-task observation pump all
read the one engine.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import math
from typing import Iterable, Mapping, Sequence

import numpy as np

from .device_model import DeviceProfile, LinearTimeModel, priority_order


# ---------------------------------------------------------------------------
# Events and timelines (moved here from core.schedule; re-exported there)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BusEvent:
    device: str
    kind: str       # "copy_in" | "compute" | "copy_out"
    start: float
    end: float
    link: str | None = None   # serialization link the event occupied
    chunk: int = 0            # pipeline chunk index (0 when unchunked)
    # Task-graph timelines attribute every event to a named task (None for
    # the divisible-workload engine, where a device runs exactly one unit).
    task: str | None = None

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Timeline:
    events: list[BusEvent]

    @property
    def makespan(self) -> float:
        return max((e.end for e in self.events), default=0.0)

    def device_events(self, name: str) -> list[BusEvent]:
        return [e for e in self.events if e.device == name]

    def device_finish(self, name: str) -> float:
        """When the device's last stage (usually copy_out) ends; 0 if idle."""
        return max((e.end for e in self.device_events(name)), default=0.0)

    def idle_time(self, name: str) -> float:
        evs = sorted(self.device_events(name), key=lambda e: e.start)
        if not evs:
            return self.makespan
        idle = evs[0].start
        for a, b in zip(evs, evs[1:]):
            idle += max(0.0, b.start - a.end)
        idle += self.makespan - evs[-1].end
        return idle

    def bus_busy_time(self) -> float:
        return sum(e.duration for e in self.events
                   if e.kind in ("copy_in", "copy_out"))

    def link_events(self, link: str) -> list[BusEvent]:
        return sorted((e for e in self.events if e.link == link),
                      key=lambda e: (e.start, e.end))

    def task_events(self, task: str) -> list[BusEvent]:
        return [e for e in self.events if e.task == task]

    def _copy_tickets(self) -> list[tuple[str, tuple]]:
        """(link, ticket) in grant order: copy events sorted by start
        (ties: copy_in before copy_out, then chunk), chunk/multi-input
        events collapsed to one ticket per stage.  Tickets are
        ``(device, kind)`` for divisible timelines and
        ``(task, device, kind)`` for task-graph timelines (a device runs
        many tasks, each with its own grant slot)."""
        out: list[tuple[str, tuple]] = []
        seen: set[tuple] = set()
        copies = sorted((e for e in self.events if e.kind != "compute"),
                        key=lambda e: (e.start, 0 if e.kind == "copy_in"
                                       else 1, e.chunk))
        for e in copies:
            ticket = (e.device, e.kind) if e.task is None \
                else (e.task, e.device, e.kind)
            if ticket in seen:
                continue
            seen.add(ticket)
            out.append((e.link or "bus", ticket))
        return out

    def link_ticket_order(self) -> dict[str, list[tuple]]:
        """Per-link grant order of tickets — this is what the overlapped
        executor's per-link ticket buses replay."""
        out: dict[str, list[tuple]] = {}
        for link, ticket in self._copy_tickets():
            out.setdefault(link, []).append(ticket)
        return out

    def ticket_order(self) -> list[tuple]:
        """Flat grant order across all links (per-link truth above)."""
        return [ticket for _, ticket in self._copy_tickets()]


# ---------------------------------------------------------------------------
# Carried-over clocks (streaming runtime, DESIGN.md §9)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClockState:
    """Where each link and device clock stands when a timeline starts.

    ``links`` / ``devices`` map names to absolute times; anything absent
    falls back to ``floor``.  ``ClockState()`` is the classic t = 0 start;
    ``ClockState(floor=t)`` is a full barrier at ``t`` (what a runtime with
    plan-carry-over disabled uses between plans); ``carry_clocks(timeline)``
    is the overlapping hand-off — each link and device resumes exactly where
    the previous plan left it.
    """

    links: Mapping[str, float] = dataclasses.field(default_factory=dict)
    devices: Mapping[str, float] = dataclasses.field(default_factory=dict)
    floor: float = 0.0

    def link(self, name: str) -> float:
        return max(self.links.get(name, self.floor), self.floor)

    def device(self, name: str) -> float:
        return max(self.devices.get(name, self.floor), self.floor)

    # -- multi-tenant views (DESIGN.md §13) ---------------------------------

    def with_floor(self, t: float) -> "ClockState":
        """The same clocks with nothing allowed to start before ``t`` — an
        arrival gate: a job admitted at ``t`` cannot occupy a link or device
        in its past, even ones the stream has not touched yet."""
        if t <= self.floor:
            return self
        return ClockState(links=self.links, devices=self.devices, floor=t)

    def restrict(self, links: "Iterable[str]",
                 devices: "Iterable[str]") -> "ClockState":
        """A tenant's view of the shared clocks: only the named links and
        devices (the ones its ``BusTopology`` can reach), same floor.  Keeps
        one tenant's private link names from leaking into another tenant's
        rebase while the SHARED names (the contended PCIe bus, the common
        accelerators) still carry across tenants."""
        lset, dset = set(links), set(devices)
        return ClockState(
            links={k: v for k, v in self.links.items() if k in lset},
            devices={k: v for k, v in self.devices.items() if k in dset},
            floor=self.floor)

    def merge(self, other: "ClockState") -> "ClockState":
        """Max-merge two clock states (same algebra as ``carry_clocks``):
        every link/device takes the later of the two clocks, the floor the
        higher of the two floors."""
        links = dict(self.links)
        for k, v in other.links.items():
            links[k] = max(links.get(k, other.floor), v)
        devices = dict(self.devices)
        for k, v in other.devices.items():
            devices[k] = max(devices.get(k, other.floor), v)
        return ClockState(links=links, devices=devices,
                          floor=max(self.floor, other.floor))


ZERO_CLOCKS = ClockState()


def carry_clocks(timeline: Timeline,
                 base: ClockState = ZERO_CLOCKS) -> ClockState:
    """The ``ClockState`` a follow-on plan should start from: each link's
    clock is its last transfer's end, each device's clock its last event's
    end (so the next plan's copies overlap this plan's tail but a device
    never runs two plans' stages at once).

    ``base`` is the state this timeline itself started from; clocks are
    max-merged into it, because a plan that never touched a link (or left a
    device idle) must not rewind that clock — e.g. an all-CPU job between
    two GPU jobs would otherwise reset the PCIe clock to zero and let the
    next plan's copies time-travel under the earlier plan's transfers."""
    links = dict(base.links)
    devices = dict(base.devices)
    for e in timeline.events:
        if e.link is not None:
            links[e.link] = max(links.get(e.link, base.floor), e.end)
        devices[e.device] = max(devices.get(e.device, base.floor), e.end)
    return ClockState(links=links, devices=devices, floor=base.floor)


# ---------------------------------------------------------------------------
# Links and topologies
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Link:
    """One serialization domain (PCIe bus, NVLink, an ICI feed...).

    ``bandwidth_bytes_per_s = None`` means the link never caps a device —
    copy times come from the device's own ``CopyModel``.  A finite value
    caps the effective bandwidth at ``min(device bw, link bw)``.
    """

    name: str
    bandwidth_bytes_per_s: float | None = None


def _has_copy(d: DeviceProfile) -> bool:
    return not math.isinf(d.copy.bandwidth_bytes_per_s)


@dataclasses.dataclass(frozen=True)
class BusTopology:
    """Which link (if any) each device's copy_in / copy_out serializes on.

    ``attach`` rows are ``(device_name, in_link, out_link)``; ``None`` link
    means the stage does not serialize with anything (no-copy devices).  A
    device with a copy model but no attach row gets an implicit private
    link (the independent-bus behaviour).
    """

    links: tuple[Link, ...]
    attach: tuple[tuple[str, str | None, str | None], ...]
    spec: str = "custom"   # short tag carried into OptimizeResult.bus
    # hierarchical (multi-host) extension: ``hosts`` groups device names
    # into host islands; a DAG edge whose producer and consumer live on
    # different hosts pays an extra NIC hop (``nic`` bandwidth cap plus
    # ``nic_latency_s``) between the producer's host-stage and the
    # consumer's copy_in.  Empty ``hosts`` means a flat (single-host)
    # topology and the engine takes the exact pre-existing code path.
    hosts: tuple[tuple[str, tuple[str, ...]], ...] = ()
    nic: Link | None = None
    nic_latency_s: float = 0.0

    def __post_init__(self) -> None:
        by_name = {l.name: l for l in self.links}
        in_map: dict[str, Link | None] = {}
        out_map: dict[str, Link | None] = {}
        for dev, lin, lout in self.attach:
            for l in (lin, lout):
                if l is not None and l not in by_name:
                    raise ValueError(f"device {dev!r} attached to unknown "
                                     f"link {l!r}; links: "
                                     f"{sorted(by_name)}")
            in_map[dev] = by_name[lin] if lin is not None else None
            out_map[dev] = by_name[lout] if lout is not None else None
        # resolved lookup tables (the engine queries these in the solver's
        # feasibility hot path; frozen dataclass, so set via object.*)
        object.__setattr__(self, "_in_map", in_map)
        object.__setattr__(self, "_out_map", out_map)
        host_of: dict[str, int] = {}
        for hi, (_hname, members) in enumerate(self.hosts):
            for dev in members:
                if dev in host_of:
                    raise ValueError(f"device {dev!r} listed under two "
                                     "hosts")
                host_of[dev] = hi
        object.__setattr__(self, "_host_of", host_of)

    # -- construction -------------------------------------------------------

    @classmethod
    def serialized(cls, devices: Sequence[DeviceProfile], *,
                   link: Link | str = "pcie") -> "BusTopology":
        """The paper's model: every copying device on one shared bus."""
        lk = Link(link) if isinstance(link, str) else link
        attach = tuple((d.name, lk.name, lk.name) if _has_copy(d)
                       else (d.name, None, None) for d in devices)
        return cls(links=(lk,), attach=attach, spec="serialized")

    @classmethod
    def independent(cls, devices: Sequence[DeviceProfile], *,
                    prefix: str = "link") -> "BusTopology":
        """Each copying device on its own private link (no contention)."""
        links: list[Link] = []
        attach: list[tuple[str, str | None, str | None]] = []
        for d in devices:
            if _has_copy(d):
                lk = Link(f"{prefix}:{d.name}")
                links.append(lk)
                attach.append((d.name, lk.name, lk.name))
            else:
                attach.append((d.name, None, None))
        return cls(links=tuple(links), attach=tuple(attach),
                   spec="independent")

    @classmethod
    def custom(cls, links: Sequence[Link | str],
               attach: Mapping[str, str | tuple[str | None, str | None] | None],
               *, spec: str = "custom") -> "BusTopology":
        """Mixed topologies: ``attach`` maps device name -> link name (both
        directions), ``(in_link, out_link)``, or ``None`` (no link)."""
        lks = tuple(Link(l) if isinstance(l, str) else l for l in links)
        rows: list[tuple[str, str | None, str | None]] = []
        for dev, spec_l in attach.items():
            if spec_l is None:
                rows.append((dev, None, None))
            elif isinstance(spec_l, str):
                rows.append((dev, spec_l, spec_l))
            else:
                rows.append((dev, spec_l[0], spec_l[1]))
        return cls(links=lks, attach=tuple(rows), spec=spec)

    @classmethod
    def cluster(cls, hosts: Mapping[str, Sequence[DeviceProfile]], *,
                nic_bandwidth_bytes_per_s: float,
                nic_latency_s: float = 0.0,
                bus: str = "pcie") -> "BusTopology":
        """Multi-host stack: each host gets its own internal shared bus
        (``{host}.{bus}``, the paper's serialized model per island) and
        hosts talk through one capped NIC.  Cross-host DAG edges price as
        a two-hop staged copy: producer host-stage -> NIC -> consumer
        copy_in (DESIGN.md §16)."""
        links: list[Link] = []
        attach: list[tuple[str, str | None, str | None]] = []
        groups: list[tuple[str, tuple[str, ...]]] = []
        for hname, devs in hosts.items():
            lk = Link(f"{hname}.{bus}")
            links.append(lk)
            for d in devs:
                attach.append((d.name, lk.name, lk.name) if _has_copy(d)
                              else (d.name, None, None))
            groups.append((hname, tuple(d.name for d in devs)))
        nic = Link("nic", bandwidth_bytes_per_s=nic_bandwidth_bytes_per_s)
        return cls(links=tuple(links), attach=tuple(attach),
                   spec="cluster", hosts=tuple(groups), nic=nic,
                   nic_latency_s=nic_latency_s)

    @classmethod
    def from_spec(cls, bus: "BusTopology | str | None",
                  devices: Sequence[DeviceProfile]) -> "BusTopology":
        """Resolve the legacy ``bus=`` strings (and None) to a topology."""
        if isinstance(bus, BusTopology):
            return bus
        if bus is None or bus == "serialized":
            return cls.serialized(devices)
        if bus == "independent":
            return cls.independent(devices)
        raise ValueError(f"unknown bus spec {bus!r} "
                         "(expected 'serialized', 'independent', or a "
                         "BusTopology)")

    # -- queries ------------------------------------------------------------

    def link(self, name: str) -> Link:
        for l in self.links:
            if l.name == name:
                return l
        raise KeyError(name)

    def link_of(self, device: str, kind: str) -> Link | None:
        """Link serializing ``device``'s ``copy_in``/``copy_out`` (or None).
        Unattached devices return None; the engine gives them a private
        link if they do copy."""
        table = self._in_map if kind in ("in", "copy_in") else self._out_map
        return table.get(device)

    def is_hierarchical(self) -> bool:
        """True when the topology groups devices into host islands."""
        return bool(self.hosts)

    def host_index(self, device: str) -> int | None:
        """Index of the host island holding ``device`` (None when flat or
        the device is not listed under any host)."""
        return self._host_of.get(device)

    def flatten(self) -> "BusTopology":
        """NIC-oblivious view: same links and attach rows, hierarchy
        erased — what a single-host planner would see.  The baseline for
        the cluster-aware placement comparison."""
        if not self.hosts:
            return self
        # distinct spec tag: context caches key on (devices, priority,
        # spec), and the flat view prices differently from the hierarchy
        return dataclasses.replace(self, hosts=(), nic=None,
                                   nic_latency_s=0.0,
                                   spec=self.spec + "-flat")

    def is_contended(self) -> bool:
        """True if any link serializes copies of two or more devices."""
        users: dict[str, set[str]] = {}
        for dev, lin, lout in self.attach:
            for l in (lin, lout):
                if l is not None:
                    users.setdefault(l, set()).add(dev)
        return any(len(v) > 1 for v in users.values())


# ---------------------------------------------------------------------------
# Copy times under a link (device CopyModel capped by link bandwidth)
# ---------------------------------------------------------------------------


def _in_time(d: DeviceProfile, link: Link | None, c: float,
             n: int, k: int) -> float:
    if link is None or link.bandwidth_bytes_per_s is None:
        return d.copy.in_time(c, n, k)   # CopyModel is the source of truth
    bw = min(d.copy.bandwidth_bytes_per_s, link.bandwidth_bytes_per_s)
    if math.isinf(bw):
        return 0.0
    return d.copy.in_bytes(c, n, k) / bw + d.copy.latency_s


def _out_time(d: DeviceProfile, link: Link | None, c: float,
              n: int, k: int) -> float:
    if link is None or link.bandwidth_bytes_per_s is None:
        return d.copy.out_time(c, n, k)  # CopyModel is the source of truth
    bw = min(d.copy.bandwidth_bytes_per_s, link.bandwidth_bytes_per_s)
    if math.isinf(bw):
        return 0.0
    return d.copy.out_bytes(c, n, k) / bw


def _link_bw(d: DeviceProfile, link: Link | None) -> float:
    bw = d.copy.bandwidth_bytes_per_s
    if link is not None and link.bandwidth_bytes_per_s is not None:
        bw = min(bw, link.bandwidth_bytes_per_s)
    return bw


def _bytes_in_time(d: DeviceProfile, link: Link | None, nbytes: float) -> float:
    """Host->device time for raw ``nbytes`` (task-graph copies are byte-
    denominated, not GEMM-shaped) under the device model capped by the link."""
    bw = _link_bw(d, link)
    if nbytes <= 0.0 or math.isinf(bw):
        return 0.0
    return nbytes / bw + d.copy.latency_s


def _bytes_out_time(d: DeviceProfile, link: Link | None, nbytes: float) -> float:
    bw = _link_bw(d, link)
    if nbytes <= 0.0 or math.isinf(bw):
        return 0.0
    return nbytes / bw


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _resolve_chunks(devices: Sequence[DeviceProfile],
                    chunks: Sequence[int] | None) -> list[int]:
    if chunks is None:
        return [max(1, int(getattr(d, "pipeline_chunks", 1)))
                for d in devices]
    return [max(1, int(c)) for c in chunks]


def _simulate(devices: Sequence[DeviceProfile], ops: Sequence[float],
              n: int, k: int, topo: BusTopology, order: Sequence[int],
              chunks: Sequence[int], events: list[BusEvent] | None,
              clocks: ClockState = ZERO_CLOCKS) -> list[float]:
    """One pass over the event graph.  Returns per-device finish times;
    appends ``BusEvent``s when ``events`` is a list (None = fast path).

    Semantics (Fig. 2, per link):
      * input copies serialize on their link in priority order;
      * a device with no input copy time starts computing at t = 0 (the
        solver historically charged it for bus queue time — bug);
      * compute chunk j starts at max(input chunk j landed, chunk j-1 done);
      * output copies serialize on their link in priority order after ALL
        input copies on that link (the link clock carries over — the solver
        historically reset it to 0, letting outputs overlap inputs — bug);
      * output chunk j additionally waits for compute chunk j.

    ``clocks`` shifts the start of the world: each link's first transfer
    begins at its carried clock and each device's first stage begins no
    earlier than its carried clock (a device runs one plan's stages at a
    time — the streaming runtime's per-device workers are sequential), so a
    plan chained after another overlaps its predecessor's tail exactly as
    the Fig. 2 schedule overlaps devices within one plan.
    """
    finish = [0.0] * len(devices)
    free: dict[str, float] = {}           # per-link clock
    chunk_ends: dict[int, list[float]] = {}  # device -> compute chunk ends

    # ---- input copies + compute, devices in priority order
    for i in order:
        d, c = devices[i], float(ops[i])
        if c <= 0.0:
            continue
        C = chunks[i]
        dev0 = clocks.device(d.name)
        link = topo.link_of(d.name, "in")
        t_total = _in_time(d, link, c, n, k)
        t_cc = d.compute(c / C)
        ends: list[float] = []
        if t_total <= 0.0:
            # no-copy device: compute immediately, chunks back to back
            prev = dev0
            for j in range(C):
                if events is not None:
                    events.append(BusEvent(d.name, "compute", prev,
                                           prev + t_cc, None, j))
                prev += t_cc
                ends.append(prev)
        else:
            lname = link.name if link is not None else f"~{d.name}"
            t_shared = _in_time(d, link, 0.0, n, k)  # B panel + latency
            t_chunk = (t_total - t_shared) / C
            # each chunk is a separate transfer: chunks past the first pay
            # the copy launch latency again (chunk 0's is in t_shared)
            lat = d.copy.latency_s
            start = max(free.get(lname, clocks.link(lname)), dev0)
            in_ends: list[float] = []
            for j in range(C):
                dur = t_chunk + (t_shared if j == 0 else lat)
                if events is not None:
                    events.append(BusEvent(d.name, "copy_in", start,
                                           start + dur, lname, j))
                start += dur
                in_ends.append(start)
            free[lname] = start
            prev = dev0
            for j in range(C):
                s = max(in_ends[j], prev)
                if events is not None:
                    events.append(BusEvent(d.name, "compute", s, s + t_cc,
                                           None, j))
                prev = s + t_cc
                ends.append(prev)
        chunk_ends[i] = ends
        finish[i] = ends[-1]

    # ---- output copies, devices in priority order, link clocks carried
    for i in order:
        d, c = devices[i], float(ops[i])
        if c <= 0.0:
            continue
        C = chunks[i]
        link = topo.link_of(d.name, "out")
        t_out = _out_time(d, link, c, n, k)
        if t_out <= 0.0:
            continue
        lname = link.name if link is not None else f"~{d.name}"
        t_chunk = t_out / C
        ends = chunk_ends[i]
        t = free.get(lname, clocks.link(lname))
        for j in range(C):
            s = max(t, ends[j])
            if events is not None:
                events.append(BusEvent(d.name, "copy_out", s, s + t_chunk,
                                       lname, j))
            t = s + t_chunk
        free[lname] = t
        finish[i] = t
    return finish


def build_timeline(devices: Sequence[DeviceProfile], ops: Sequence[float],
                   n: int, k: int, *,
                   topology: BusTopology | str | None = None,
                   order: Sequence[int] | None = None,
                   chunks: Sequence[int] | None = None,
                   clocks: ClockState = ZERO_CLOCKS) -> Timeline:
    """The unified event-graph timeline (what ``simulate_timeline`` returns,
    what the solver's finish times are read from, and what the overlapped
    executor's per-link ticket order is derived from).  ``clocks`` starts
    the timeline from carried-over link/device clocks instead of t = 0
    (streaming runtime)."""
    topo = BusTopology.from_spec(topology, devices)
    if order is None:
        order = priority_order(devices)
    events: list[BusEvent] = []
    _simulate(devices, ops, n, k, topo, order, _resolve_chunks(devices, chunks),
              events, clocks)
    return Timeline(events)


def engine_finish_times(devices: Sequence[DeviceProfile],
                        ops: Sequence[float], n: int, k: int, *,
                        topology: BusTopology | str | None = None,
                        order: Sequence[int] | None = None,
                        chunks: Sequence[int] | None = None,
                        clocks: ClockState = ZERO_CLOCKS) -> list[float]:
    """Per-device finish times from the same control flow as
    ``build_timeline``, without materializing events (solver hot path)."""
    topo = BusTopology.from_spec(topology, devices)
    if order is None:
        order = priority_order(devices)
    return _simulate(devices, ops, n, k, topo, order,
                     _resolve_chunks(devices, chunks), None, clocks)


# ---------------------------------------------------------------------------
# TimelineSpec — everything needed to re-price a planned timeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TimelineSpec:
    """The engine inputs a ``Schedule``'s timeline was built from.

    Domains attach this to their ``Schedule`` so a runtime can *rebase* the
    plan — rebuild the identical event graph from carried-over clocks, or
    under different (e.g. ground-truth) device models — without knowing any
    domain geometry.  ``order`` is the planned priority order; replaying a
    plan under substituted models must keep it (the executor's ticket buses
    grant in planned order, not in the substituted models' speed order).
    """

    devices: tuple[DeviceProfile, ...]
    ops: tuple[float, ...]
    n: int
    k: int
    topology: BusTopology
    chunks: tuple[int, ...] | None = None
    order: tuple[int, ...] | None = None

    def rebase(self, clocks: ClockState = ZERO_CLOCKS, *,
               devices: Sequence[DeviceProfile] | None = None) -> Timeline:
        """Rebuild the timeline from ``clocks``; ``devices`` substitutes
        ground-truth profiles (same names/positions) for the planned ones."""
        devs = list(devices) if devices is not None else list(self.devices)
        order = list(self.order) if self.order is not None \
            else priority_order(list(self.devices))
        return build_timeline(devs, list(self.ops), self.n, self.k,
                              topology=self.topology, order=order,
                              chunks=list(self.chunks) if self.chunks else None,
                              clocks=clocks)

    def ops_by_device(self) -> dict[str, float]:
        return {d.name: float(c) for d, c in zip(self.devices, self.ops)}


# ---------------------------------------------------------------------------
# Task-graph engine — precedence-constrained DAGs on the same clocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """One DAG task as the engine sees it: an op count plus byte counts.

    ``in_bytes`` is the task's *external* (host-resident) input — weights,
    graph inputs; data produced by upstream tasks travels on the edges and
    is priced from the producer's ``out_bytes``.  ``out_bytes`` is what the
    task emits: it is copied back to host when the task is a sink or feeds
    a consumer on another device (the host-staged transfer of the paper's
    bus model), and read over the consumer's input link per cross-device
    edge."""

    name: str
    ops: float
    in_bytes: float = 0.0
    out_bytes: float = 0.0


def _graph_topo_order(n: int, edges: Sequence[tuple[int, int]]) -> list[int]:
    """Kahn topological order, stable by task index (callers validate
    acyclicity; a cycle here raises).  The ready frontier is a heap: a
    wide DAG (microbatched whole-model stacks keep dozens of chains open
    at once) made the old ``min(ready)`` + ``list.remove`` frontier a
    measurable O(n·width) slice of the 10^4-node hierarchical solve."""
    indeg = [0] * n
    children: list[list[int]] = [[] for _ in range(n)]
    for u, v in edges:
        indeg[v] += 1
        children[u].append(v)
    ready = [i for i in range(n) if indeg[i] == 0]
    heapq.heapify(ready)
    out: list[int] = []
    while ready:
        i = heapq.heappop(ready)
        out.append(i)
        for c in children[i]:
            indeg[c] -= 1
            if indeg[c] == 0:
                heapq.heappush(ready, c)
    if len(out) != n:
        raise ValueError("task graph contains a cycle")
    return out


class GraphSimContext:
    """Immutable per-graph context shared by every ``GraphSimState``.

    Built once per (graph, topology, order, clocks, ext) tuple: adjacency
    in edge-insertion order, each device's resolved in/out link, and the
    positions of the simulated (non-``ext``) tasks in ``order``.  The list
    scheduler builds one of these per solve and extends checkpointed
    ``GraphSimState``s against it instead of re-deriving the lookup tables
    for every candidate placement.
    """

    __slots__ = ("devices", "tasks", "edges", "topo", "order", "clocks",
                 "ext", "n", "parents", "children", "pos_of", "has_copy",
                 "in_link", "in_lname", "out_link", "out_lname", "dev_name",
                 "sim_positions", "link_names", "in_lid", "out_lid",
                 "has_out", "has_in", "ext_in", "par_in", "stage_out",
                 "comp", "host_id", "hier", "nic_dur", "_np", "_ext_seed")

    # every per-graph table that depends only on (devices, tasks, edges,
    # topo, order) — shared, not copied, by ``rebind``
    _SHARED_SLOTS = ("devices", "tasks", "edges", "topo", "order", "n",
                     "parents", "children", "pos_of", "has_copy", "in_link",
                     "in_lname", "out_link", "out_lname", "dev_name",
                     "link_names", "in_lid", "out_lid", "has_out", "has_in",
                     "ext_in", "par_in", "stage_out", "comp", "host_id",
                     "hier", "nic_dur", "_np")

    def __init__(self, devices: Sequence[DeviceProfile],
                 tasks: Sequence[TaskSpec],
                 edges: Sequence[tuple[int, int]],
                 topo: BusTopology, order: Sequence[int],
                 clocks: ClockState = ZERO_CLOCKS,
                 ext: Mapping[int, tuple[float, float]] | None = None):
        self.devices = list(devices)
        self.tasks = list(tasks)
        self.edges = list(edges)
        self.topo = topo
        self.order = list(order)
        self.clocks = clocks
        self.ext = dict(ext) if ext else {}
        n = self.n = len(self.tasks)
        parents: list[list[int]] = [[] for _ in range(n)]
        children: list[list[int]] = [[] for _ in range(n)]
        for u, v in self.edges:
            parents[v].append(u)
            children[u].append(v)
        self.parents = parents
        self.children = children
        self.pos_of = {i: p for p, i in enumerate(self.order)}
        self.has_copy = [_has_copy(d) for d in self.devices]
        self.dev_name = [d.name for d in self.devices]
        self.in_link = [topo.link_of(d.name, "in") for d in self.devices]
        self.out_link = [topo.link_of(d.name, "out") for d in self.devices]
        self.in_lname = [l.name if l is not None else f"~{d.name}"
                         for d, l in zip(self.devices, self.in_link)]
        self.out_lname = [l.name if l is not None else f"~{d.name}"
                          for d, l in zip(self.devices, self.out_link)]
        # positions that can ever be simulated (ext tasks never are) — lets
        # a partial re-solve's suffix walk skip the frozen 95% in O(1)
        self.sim_positions = [p for p, i in enumerate(self.order)
                              if i not in self.ext]
        # integer link ids: the hot loop indexes clock lists instead of
        # hashing link-name strings
        link_id: dict[str, int] = {}
        for nm in self.in_lname + self.out_lname:
            if nm not in link_id:
                link_id[nm] = len(link_id)
        self.link_names = list(link_id)
        self.in_lid = [link_id[nm] for nm in self.in_lname]
        self.out_lid = [link_id[nm] for nm in self.out_lname]
        self.has_out = [t.out_bytes > 0.0 for t in self.tasks]
        self.has_in = [t.in_bytes > 0.0 for t in self.tasks]
        # per-(device, task) duration tables — every copy/compute duration
        # the simulation loop can ever need, priced once via the same
        # formulas as _bytes_in_time/_bytes_out_time/DeviceProfile.compute
        # (elementwise numpy float64 ops match Python floats exactly)
        in_b = np.array([float(t.in_bytes) for t in self.tasks])
        out_b = np.array([float(t.out_bytes) for t in self.tasks])
        ops = np.array([float(t.ops) for t in self.tasks])
        zeros = [0.0] * n
        self.ext_in = []    # [j][i]: task i's external input into device j
        self.par_in = []    # [j][i]: producer i's output copied into j
        self.stage_out = []  # [j][i]: task i's output staged out of j
        self.comp = []      # [j][i]: task i's compute time on j
        for j, d in enumerate(self.devices):
            bw_in = _link_bw(d, self.in_link[j])
            if math.isinf(bw_in):
                self.ext_in.append(zeros)
                self.par_in.append(zeros)
            else:
                lat = d.copy.latency_s
                self.ext_in.append(np.where(in_b <= 0.0, 0.0,
                                            in_b / bw_in + lat).tolist())
                self.par_in.append(np.where(out_b <= 0.0, 0.0,
                                            out_b / bw_in + lat).tolist())
            bw_out = _link_bw(d, self.out_link[j])
            if math.isinf(bw_out):
                self.stage_out.append(zeros)
            else:
                self.stage_out.append(np.where(out_b <= 0.0, 0.0,
                                               out_b / bw_out).tolist())
            tm = d.compute
            if isinstance(tm, LinearTimeModel):
                self.comp.append((tm.a * ops + tm.b).tolist())
            else:
                self.comp.append([tm(t.ops) for t in self.tasks])
        # hierarchical topologies: host island per device plus the per-task
        # NIC hop (out_bytes / nic_bw + nic_latency) a cross-host edge pays
        # between the producer's host-stage and the consumer's copy_in.
        # Flat topologies keep hier=False and never read these — the exact
        # pre-hierarchy float sequence (byte-identity, DESIGN.md §12/§16).
        self.hier = topo.is_hierarchical()
        if self.hier:
            self.host_id = [-1 if (h := topo.host_index(d.name)) is None
                            else h for d in self.devices]
            nic_bw = (topo.nic.bandwidth_bytes_per_s
                      if topo.nic is not None else None)
            lat = topo.nic_latency_s
            if nic_bw is None or math.isinf(nic_bw):
                self.nic_dur = np.where(out_b <= 0.0, 0.0, lat).tolist()
            else:
                self.nic_dur = np.where(out_b <= 0.0, 0.0,
                                        out_b / nic_bw + lat).tolist()
        else:
            self.host_id = [-1] * len(self.devices)
            self.nic_dur = zeros
        self._np = None   # lazy numpy views of the duration tables
        self._ext_seed = None   # lazy (compute_end, avail, finish) template

    def ext_seed(self) -> tuple[list[float], list[float], list[float]]:
        """Per-task ``(compute_end, avail, finish)`` start lists with the
        ``ext`` entries already written — built once per context (or
        ``rebind``) and list-copied by every ``GraphSimState``, so repeated
        state construction against the same frozen set stops re-walking the
        ext dict (a partial re-solve freezes ~90% of a large order, and a
        refined solve builds several states per call)."""
        if self._ext_seed is None:
            n = self.n
            ce_l = [0.0] * n
            av_l = [0.0] * n
            fin_l = [0.0] * n
            for i, (c_end, av) in self.ext.items():
                ce_l[i] = c_end
                av_l[i] = av
                fin_l[i] = c_end   # fixed past/in-flight work; never inf
            self._ext_seed = (ce_l, av_l, fin_l)
        return self._ext_seed

    def rebind(self, clocks: ClockState,
               ext: Mapping[int, tuple[float, float]] | None
               ) -> "GraphSimContext":
        """A context sharing every per-graph table with ``self``, re-keyed
        onto fresh carried clocks and a fresh ``ext`` map — the only inputs
        a repeated re-solve of the *same* graph changes between calls.
        O(n): only ``sim_positions`` is rebuilt; the duration tables,
        adjacency, and link ids (the expensive part of ``__init__``) are
        shared.  The straggler-rescue path re-plans the same DAG every few
        milliseconds; paying full context construction per re-plan was a
        measurable slice of the re-solve latency (DESIGN.md §14)."""
        c = GraphSimContext.__new__(GraphSimContext)
        for slot in GraphSimContext._SHARED_SLOTS:
            setattr(c, slot, getattr(self, slot))
        c.clocks = clocks
        c.ext = dict(ext) if ext else {}
        eset = c.ext
        c.sim_positions = [p for p, i in enumerate(c.order) if i not in eset]
        c._ext_seed = None
        return c

    def np_tables(self) -> "_NpTables":
        """The per-(device, task) duration tables as (d, n) numpy arrays
        (built once, cached; shared across ``rebind``s) — the vectorized
        candidate-pricing lanes index these instead of the python lists."""
        if self._np is None:
            self._np = _NpTables(self)
        return self._np


class _NpTables:
    """Numpy views of a ``GraphSimContext``'s duration tables, for the
    vectorized pricing paths (``optimize._peek_batch``, ``GraphSimBatch``).
    Built from the same python lists the scalar loop reads, so elementwise
    IEEE float64 operations over them match the scalar engine exactly."""

    __slots__ = ("has_copy", "ext_in", "par_in", "stage_out", "comp",
                 "in_lid", "out_lid", "idx", "same_link", "hier", "host",
                 "nic_dur")

    def __init__(self, ctx: "GraphSimContext"):
        self.has_copy = np.array(ctx.has_copy, dtype=bool)
        self.ext_in = np.array(ctx.ext_in)
        self.par_in = np.array(ctx.par_in)
        self.stage_out = np.array(ctx.stage_out)
        self.comp = np.array(ctx.comp)
        self.in_lid = np.array(ctx.in_lid, dtype=np.intp)
        self.out_lid = np.array(ctx.out_lid, dtype=np.intp)
        self.idx = np.arange(len(ctx.devices))
        self.same_link = np.array([a == b for a, b in
                                   zip(ctx.in_lid, ctx.out_lid)])
        self.hier = ctx.hier
        self.host = np.array(ctx.host_id, dtype=np.intp)
        self.nic_dur = np.array(ctx.nic_dur)


class GraphSimState:
    """Resumable task-graph simulation — the checkpoint/extend engine.

    Holds everything ``_simulate_graph`` used to rebuild per pass: the
    per-link and per-device clocks, per-task ``(compute_end, avail)``
    pairs, the finish times, and the placed set.  ``advance(stop)``
    simulates order positions ``[pos, stop)`` under the *current*
    ``assign``/``placed``; ``clone()`` snapshots the state in O(n); and
    ``peek_finish(i, j)`` prices "task ``i`` next, on device ``j``" in
    O(deg(i)) without mutating anything.  The from-scratch
    ``graph_finish_times`` path is a single ``advance`` over a fresh
    state, so incremental results equal from-scratch results *exactly* —
    there is only one simulation loop (DESIGN.md §12).

    Exactness caveat the list scheduler must handle: whether a producer's
    output is host-staged (``_needs_out``) depends on its *placed
    children's* devices, so placing a new task can retroactively change a
    parent's stage decision.  ``stage_flip_pos(i, j)`` reports the
    earliest simulated position whose decision would change — ``None``
    means extending the checkpoint is exact; otherwise the caller must
    re-simulate from a snapshot at or before that position.
    """

    __slots__ = ("ctx", "pos", "lclock", "dclock", "finish", "compute_end",
                 "avail", "reclaim", "assign", "placed")

    def __init__(self, ctx: GraphSimContext, assign: Sequence[int],
                 placed: Sequence[int] | None = None):
        self.ctx = ctx
        self.assign = list(assign)
        flags = bytearray(ctx.n)
        if placed is None:
            for i in ctx.order:
                if self.assign[i] >= 0 and i not in ctx.ext:
                    flags[i] = 1
            for i in ctx.ext:
                flags[i] = 1
        else:
            for i in placed:
                flags[i] = 1
        self.placed = flags
        self.pos = 0
        # clock lists indexed by ctx link id / device index; None = the
        # carried-over start value from ctx.clocks
        self.lclock: list[float | None] = [None] * len(ctx.link_names)
        self.dclock: list[float | None] = [None] * len(ctx.devices)
        ce_l, av_l, fin_l = ctx.ext_seed()
        self.finish = list(fin_l)
        self.compute_end = list(ce_l)
        self.avail = list(av_l)
        # link time a task's host-stage holds, INCLUDING the idle gap its
        # compute-end barrier inserts: stage end minus the link clock as
        # the stage was scheduled.  This is the exact span a vanish flip
        # returns to the link, so ``stage_flip_pos`` callers can LOWER-
        # bound a flipped candidate's price by ``stale peek - reclaim``
        # (DESIGN.md §14).  0.0 for tasks that do not stage.
        self.reclaim = [0.0] * ctx.n

    def clone(self) -> "GraphSimState":
        st = GraphSimState.__new__(GraphSimState)
        st.ctx = self.ctx
        st.pos = self.pos
        st.lclock = list(self.lclock)
        st.dclock = list(self.dclock)
        st.finish = list(self.finish)
        st.compute_end = list(self.compute_end)
        st.avail = list(self.avail)
        st.reclaim = list(self.reclaim)
        st.assign = list(self.assign)
        st.placed = bytearray(self.placed)
        return st

    def snap_clone(self) -> "GraphSimState":
        """A clone for snapshot chains: clocks and per-task times are
        copied, but ``assign``/``placed`` *alias* the live lists — every
        chain snapshot is rebound onto its caller's live assign/placed
        before use (``_SnapChain.state_at``), so copying them per snapshot
        was pure overhead on the hot re-solve path."""
        st = GraphSimState.__new__(GraphSimState)
        st.ctx = self.ctx
        st.pos = self.pos
        st.lclock = list(self.lclock)
        st.dclock = list(self.dclock)
        st.finish = list(self.finish)
        st.compute_end = list(self.compute_end)
        st.avail = list(self.avail)
        st.reclaim = list(self.reclaim)
        st.assign = self.assign
        st.placed = self.placed
        return st

    # -- energy accounting (DESIGN.md §16) -----------------------------------

    def device_busy(self) -> list[float]:
        """Per-device busy seconds of the current assignment: the sum of
        each placed non-ext task's compute time on its device, from the
        same ``ctx.comp`` table the simulation prices.  Assignment-
        determined, so valid before *and* after ``advance``."""
        ctx = self.ctx
        busy = [0.0] * len(ctx.devices)
        for i in range(ctx.n):
            j = self.assign[i]
            if j >= 0 and self.placed[i] and i not in ctx.ext:
                busy[j] += ctx.comp[j][i]
        return busy

    def energy_joules(self, makespan: float | None = None) -> float:
        """Total joules under the device power models: per-op dynamic
        energy plus idle watts over each device's schedule gap.  With no
        ``makespan`` given, uses the simulated finish horizon."""
        ctx = self.ctx
        if makespan is None:
            makespan = max(self.finish, default=0.0)
        busy = self.device_busy()
        e = 0.0
        for i in range(ctx.n):
            j = self.assign[i]
            if j >= 0 and self.placed[i] and i not in ctx.ext:
                e += ctx.devices[j].joules_per_op * float(ctx.tasks[i].ops)
        for d, b in zip(ctx.devices, busy):
            if d.idle_watts > 0.0 and makespan > b:
                e += d.idle_watts * (makespan - b)
        return e

    # -- clock reads (None = carried-over start) -----------------------------

    def link_clock_id(self, lid: int) -> float:
        v = self.lclock[lid]
        if v is None:
            return self.ctx.clocks.link(self.ctx.link_names[lid])
        return v

    def dev_clock_id(self, j: int) -> float:
        v = self.dclock[j]
        if v is None:
            return self.ctx.clocks.device(self.ctx.dev_name[j])
        return v

    # -- the one simulation loop ---------------------------------------------

    def advance(self, stop: int, events: list[BusEvent] | None = None,
                bound: float | None = None) -> bool:
        """Simulate order positions ``[pos, stop)`` (ext/unassigned tasks
        skipped), appending ``BusEvent``s when ``events`` is a list.

        ``bound`` is a branch-and-bound early exit (DESIGN.md §14): every
        simulated task's finish time lower-bounds the final makespan (link
        and device clocks never rewind), so the moment a finish exceeds
        ``bound`` the caller's candidate cannot beat its incumbent and the
        walk aborts, returning False with the state mid-advance (throwaway
        states only).  A completed advance (returns True) is byte-identical
        to an unbounded one — the bound only *skips* work, it never changes
        a simulated value."""
        if stop <= self.pos:
            return True
        ctx = self.ctx
        sp = ctx.sim_positions
        lo = bisect.bisect_left(sp, self.pos)
        hi = bisect.bisect_left(sp, stop)
        assign = self.assign
        if events is not None:
            # event-recording path: the readable reference loop
            finish = self.finish
            for idx in range(lo, hi):
                i = ctx.order[sp[idx]]
                if assign[i] >= 0:
                    self._sim_task(i, events)
                    if bound is not None and finish[i] > bound:
                        self.pos = sp[idx] + 1
                        return False
            self.pos = stop
            return True
        # hot path: ``_sim_task`` inlined with every per-step attribute
        # lookup hoisted out of the loop — the adoption re-simulations of
        # a large partial re-solve run this body thousands of times per
        # solve, where method dispatch and repeated ``self.``/``ctx.``
        # loads were a measured ~30% of the re-plan latency (DESIGN.md
        # §14).  Any semantic change here must be mirrored in _sim_task
        # (the property suite pins the two paths to identical results).
        order = ctx.order
        placed = self.placed
        lclock, dclock = self.lclock, self.dclock
        finish, compute_end = self.finish, self.compute_end
        avail, reclaim = self.avail, self.reclaim
        parents, children = ctx.parents, ctx.children
        has_out, has_in, has_copy = ctx.has_out, ctx.has_in, ctx.has_copy
        in_lid_t, out_lid_t = ctx.in_lid, ctx.out_lid
        ext_in_t, par_in_t = ctx.ext_in, ctx.par_in
        stage_out_t, comp_t = ctx.stage_out, ctx.comp
        link_names, dev_name = ctx.link_names, ctx.dev_name
        clocks = ctx.clocks
        hier, host_t, nic_t = ctx.hier, ctx.host_id, ctx.nic_dur
        inf = math.inf
        for idx in range(lo, hi):
            i = order[sp[idx]]
            j = assign[i]
            if j < 0:
                continue
            lid = in_lid_t[j]
            hc = has_copy[j]
            hj = host_t[j] if hier else -1
            ready = 0.0
            if hc and has_in[i]:
                s = lclock[lid]
                if s is None:
                    s = clocks.link(link_names[lid])
                s += ext_in_t[j][i]
                lclock[lid] = s
                ready = s
            pin = par_in_t[j]
            for u in parents[i]:
                if not placed[u]:
                    continue
                if assign[u] == j:
                    r = compute_end[u]             # same device: free
                elif not hc or not has_out[u]:
                    r = avail[u]                   # host reads staged copy
                    if hier and hj >= 0:
                        q = assign[u]
                        if q >= 0 and 0 <= host_t[q] != hj:
                            r += nic_t[u]          # staged on a remote host
                else:
                    s = lclock[lid]
                    if s is None:
                        s = clocks.link(link_names[lid])
                    au = avail[u]
                    if hier and hj >= 0:
                        q = assign[u]
                        if q >= 0 and 0 <= host_t[q] != hj:
                            au += nic_t[u]         # NIC hop before copy_in
                    if au > s:
                        s = au
                    s += pin[u]
                    lclock[lid] = s
                    r = s
                if r > ready:
                    ready = r
            s = dclock[j]
            if s is None:
                s = clocks.device(dev_name[j])
            if ready > s:
                s = ready
            ce = s + comp_t[j][i]
            dclock[j] = ce
            compute_end[i] = ce
            fin_i = ce
            av_i = ce
            rec_i = 0.0
            if has_out[i] and hc:
                # inlined _would_need_out: pseudo-sink or cross consumer
                seen = False
                need = False
                for c in children[i]:
                    if not placed[c]:
                        continue
                    seen = True
                    if assign[c] != j:
                        need = True
                        break
                if need or not seen:
                    ol = out_lid_t[j]
                    s = lclock[ol]
                    if s is None:
                        s = clocks.link(link_names[ol])
                    prev = s
                    if ce > s:
                        s = ce
                    nd = s + stage_out_t[j][i]
                    lclock[ol] = nd
                    av_i = nd
                    fin_i = nd
                    rec_i = 0.0 if prev == inf else nd - prev
            finish[i] = fin_i
            avail[i] = av_i
            reclaim[i] = rec_i
            if bound is not None and fin_i > bound:
                self.pos = sp[idx] + 1
                return False
        self.pos = stop
        return True

    def _sim_task(self, i: int, events: list[BusEvent] | None = None
                  ) -> None:
        ctx = self.ctx
        assign = self.assign
        j = assign[i]
        t = ctx.tasks[i]
        in_lid = ctx.in_lid[j]
        has_copy = ctx.has_copy[j]
        placed = self.placed
        lclock, compute_end, avail = self.lclock, self.compute_end, self.avail
        ready = 0.0
        chunk = 0

        # external (host) input bytes
        if has_copy and t.in_bytes > 0.0:
            dur = ctx.ext_in[j][i]
            s = lclock[in_lid]
            if s is None:
                s = ctx.clocks.link(ctx.link_names[in_lid])
            if events is not None:
                events.append(BusEvent(ctx.dev_name[j], "copy_in", s,
                                       s + dur, ctx.in_lname[j], chunk,
                                       t.name))
            chunk += 1
            lclock[in_lid] = s + dur
            ready = s + dur

        # precedence edges (cross-host producers pay the NIC hop as a
        # delay on their staged output's availability — DESIGN.md §16)
        hier = ctx.hier
        host_t, nic_t = ctx.host_id, ctx.nic_dur
        hj = host_t[j] if hier else -1
        par_in = ctx.par_in[j]
        for u in ctx.parents[i]:
            if not placed[u]:
                continue
            if assign[u] == j:
                r = compute_end[u]             # same device: free
            elif not has_copy or not ctx.has_out[u]:
                r = avail[u]                   # host reads the staged copy
                if hier and hj >= 0:
                    q = assign[u]
                    if q >= 0 and 0 <= host_t[q] != hj:
                        r += nic_t[u]          # staged on a remote host
            else:
                dur = par_in[u]
                s = lclock[in_lid]
                if s is None:
                    s = ctx.clocks.link(ctx.link_names[in_lid])
                au = avail[u]
                if hier and hj >= 0:
                    q = assign[u]
                    if q >= 0 and 0 <= host_t[q] != hj:
                        au += nic_t[u]         # NIC hop before copy_in
                if au > s:
                    s = au
                if events is not None:
                    events.append(BusEvent(ctx.dev_name[j], "copy_in", s,
                                           s + dur, ctx.in_lname[j], chunk,
                                           t.name))
                chunk += 1
                lclock[in_lid] = s + dur
                r = s + dur
            if r > ready:
                ready = r

        # compute
        s = self.dclock[j]
        if s is None:
            s = ctx.clocks.device(ctx.dev_name[j])
        if ready > s:
            s = ready
        dur = ctx.comp[j][i]
        if events is not None:
            events.append(BusEvent(ctx.dev_name[j], "compute", s, s + dur,
                                   None, 0, t.name))
        ce = s + dur
        self.dclock[j] = ce
        compute_end[i] = ce
        self.finish[i] = ce
        avail[i] = ce   # no-copy device: output is host-resident now
        self.reclaim[i] = 0.0

        # staged / returned output
        if self._would_need_out(i, j):
            out_lid = ctx.out_lid[j]
            dur = ctx.stage_out[j][i]
            s = lclock[out_lid]
            if s is None:
                s = ctx.clocks.link(ctx.link_names[out_lid])
            prev = s
            if ce > s:
                s = ce
            if events is not None:
                events.append(BusEvent(ctx.dev_name[j], "copy_out", s,
                                       s + dur, ctx.out_lname[j], 0, t.name))
            lclock[out_lid] = s + dur
            avail[i] = s + dur
            self.finish[i] = s + dur
            # inf - inf guard: an already-infinite link clock stays
            # infinite whether or not this stage exists, so the vanish
            # reclaims nothing
            self.reclaim[i] = 0.0 if prev == math.inf else s + dur - prev

    # -- stage decision ------------------------------------------------------

    def _would_need_out(self, i: int, j: int) -> bool:
        """Whether task ``i`` on device ``j`` stages its output to host:
        it is a pseudo-sink (no placed consumers) or feeds a placed
        consumer on another device."""
        ctx = self.ctx
        if not ctx.has_out[i] or not ctx.has_copy[j]:
            return False   # host output is already host-resident
        placed, assign = self.placed, self.assign
        seen = False
        for c in ctx.children[i]:
            if not placed[c]:
                continue
            seen = True
            if assign[c] != j:
                return True
        return not seen    # sink (or all consumers unscheduled): return C

    def needs_out(self, i: int) -> bool:
        return self._would_need_out(i, self.assign[i])

    # -- incremental extension -----------------------------------------------

    def peek_finish(self, i: int, j: int) -> float:
        """Price task ``i`` as the next committed task, on device ``j``,
        without mutating the state — exact when ``stage_flip_pos(i, j)``
        is None (no already-simulated producer's stage decision changes)."""
        ctx = self.ctx
        t = ctx.tasks[i]
        in_lid = ctx.in_lid[j]
        has_copy = ctx.has_copy[j]
        placed, assign = self.placed, self.assign
        lc: float | None = None   # local overlay of the in-link clock

        ready = 0.0
        if has_copy and t.in_bytes > 0.0:
            s = self.link_clock_id(in_lid)
            lc = s + ctx.ext_in[j][i]
            ready = lc
        hier = ctx.hier
        host_t, nic_t = ctx.host_id, ctx.nic_dur
        hj = host_t[j] if hier else -1
        par_in = ctx.par_in[j]
        for u in ctx.parents[i]:
            if not placed[u]:
                continue
            if assign[u] == j:
                r = self.compute_end[u]
            elif not has_copy or not ctx.has_out[u]:
                r = self.avail[u]
                if hier and hj >= 0:
                    q = assign[u]
                    if q >= 0 and 0 <= host_t[q] != hj:
                        r += nic_t[u]
            else:
                s = lc if lc is not None else self.link_clock_id(in_lid)
                au = self.avail[u]
                if hier and hj >= 0:
                    q = assign[u]
                    if q >= 0 and 0 <= host_t[q] != hj:
                        au += nic_t[u]
                if au > s:
                    s = au
                lc = s + par_in[u]
                r = lc
            if r > ready:
                ready = r
        s = self.dev_clock_id(j)
        if ready > s:
            s = ready
        ce = s + ctx.comp[j][i]
        if self._would_need_out(i, j):
            out_lid = ctx.out_lid[j]
            if out_lid == in_lid and lc is not None:
                s = lc
            else:
                s = self.link_clock_id(out_lid)
            if ce > s:
                s = ce
            return s + ctx.stage_out[j][i]
        return ce

    def price_lanes(self, i: int, nd: int
                    ) -> tuple[list[float], list[int | None], list[float]]:
        """Fused ``peek_finish`` + ``_stage_flip_info`` over every device
        lane in ONE walk of ``i``'s neighborhood: returns per-device
        ``(peeks, flip_positions, vanish_slacks)``.

        The scalar EFT placer calls this once per task instead of ``d``
        peeks plus ``d`` flip scans — the dominant redundancy was each
        per-lane flip scan re-walking every producer's children, when one
        walk yields the producer's (seen, cross) pair from which every
        lane's flip direction follows in O(1): a producer staging for a
        pseudo-sink (``not seen and not cross``) vanishes only on its own
        lane, one with co-located consumers (``seen and not cross``)
        appears on every other lane, and a cross-feeding producer never
        flips.  Per-lane float operations replicate ``peek_finish``'s
        sequence exactly, so selection stays bit-identical (pinned by the
        property suite)."""
        ctx = self.ctx
        placed, assign = self.placed, self.assign
        pos_of, ext = ctx.pos_of, ctx.ext
        children = ctx.children
        has_out, has_copy = ctx.has_out, ctx.has_copy
        in_lid, out_lid = ctx.in_lid, ctx.out_lid
        compute_end, avail, reclaim = self.compute_end, self.avail, \
            self.reclaim
        mypos = self.pos
        hier, host_t, nic_t = ctx.hier, ctx.host_id, ctx.nic_dur
        flip: list[int | None] = [None] * nd
        slack = [0.0] * nd
        lc: list[float | None] = [None] * nd
        ready = [0.0] * nd
        if ctx.has_in[i]:
            ext_in = ctx.ext_in
            for j in range(nd):
                if has_copy[j]:
                    s = self.link_clock_id(in_lid[j])
                    s += ext_in[j][i]
                    lc[j] = s
                    ready[j] = s
        par_in = ctx.par_in
        for u in ctx.parents[i]:
            if not placed[u]:
                continue
            au = assign[u]
            hou = has_out[u]
            # flip scan: one children walk per qualifying producer
            if au >= 0 and hou and has_copy[au] and u not in ext:
                pu = pos_of.get(u)
                if pu is not None and pu < mypos:
                    seen = False
                    cross = False
                    for c in children[u]:
                        if placed[c]:
                            seen = True
                            if assign[c] != au:
                                cross = True
                                break
                    if not cross:
                        if not seen:
                            # staged as pseudo-sink: vanishes iff i lands
                            # co-located (lane au only)
                            slack[au] += reclaim[u]
                            f = flip[au]
                            if f is None or pu < f:
                                flip[au] = pu
                        else:
                            # co-located consumers: appears on every
                            # cross lane
                            for j in range(nd):
                                if j != au:
                                    f = flip[j]
                                    if f is None or pu < f:
                                        flip[j] = pu
            # peek contribution, lane by lane (scalar op order per lane)
            ceu = compute_end[u]
            avu = avail[u]
            hq = host_t[au] if (hier and au >= 0) else -1
            ndur = nic_t[u]
            for j in range(nd):
                if au == j:
                    r = ceu
                elif not has_copy[j] or not hou:
                    r = avu
                    if hq >= 0 and 0 <= host_t[j] != hq:
                        r += ndur
                else:
                    s = lc[j]
                    if s is None:
                        s = self.link_clock_id(in_lid[j])
                    a2 = avu
                    if hq >= 0 and 0 <= host_t[j] != hq:
                        a2 += ndur
                    if a2 > s:
                        s = a2
                    s += par_in[j][u]
                    lc[j] = s
                    r = s
                if r > ready[j]:
                    ready[j] = r
        hoi = has_out[i]
        kid_devs = ([assign[c] for c in children[i] if placed[c]]
                    if hoi else None)
        comp, stage_out = ctx.comp, ctx.stage_out
        peeks = [0.0] * nd
        for j in range(nd):
            s = self.dev_clock_id(j)
            if ready[j] > s:
                s = ready[j]
            ce = s + comp[j][i]
            if hoi and has_copy[j]:
                if kid_devs:
                    need = False
                    for d in kid_devs:
                        if d != j:
                            need = True
                            break
                else:
                    need = True   # pseudo-sink: output returns to host
                if need:
                    ol = out_lid[j]
                    if ol == in_lid[j] and lc[j] is not None:
                        s2 = lc[j]
                    else:
                        s2 = self.link_clock_id(ol)
                    if ce > s2:
                        s2 = ce
                    ce = s2 + stage_out[j][i]
            peeks[j] = ce
        return peeks, flip, slack

    def stage_flip_pos(self, i: int, j: int) -> int | None:
        """Earliest already-simulated order position whose host-stage
        decision would change if ``assign[i]`` became ``j`` and ``i``
        joined the placed set (None = none; extending the checkpoint is
        exact).  Only ``i``'s producers can flip: a producer that staged
        for a pseudo-sink stops staging when its first placed consumer is
        co-located (vanish), and one whose placed consumers were all
        co-located starts staging when ``i`` lands cross-device (appear).
        """
        return self._stage_flip_info(i, j)[0]

    def _stage_flip_info(self, i: int, j: int
                         ) -> tuple[int | None, bool, bool, float]:
        """``(earliest flip pos | None, appear_only, vanish_only, slack)``.

        Direction of each flip, for the interval bounds the EFT placer
        uses on its stale peeks (DESIGN.md §14): an *appear* flip (a
        producer starts staging) only inserts extra link occupancy, so
        the stale peek is a LOWER bound on the exact price; a *vanish*
        flip (a pseudo-sink producer stops staging) only removes
        occupancy, so the stale peek is an UPPER bound.  ``slack`` is the
        total link time the vanishes return: each flipped producer's
        ``reclaim`` span — its stage duration PLUS the idle gap the
        compute-end barrier inserted on the link (the barrier matters:
        deleting the stage lets queued transfers restart from the
        pre-stage link clock, not merely ``stage_out`` earlier).  The
        engine's clocks are (max, +) compositions of their inputs, so
        returning ``s`` seconds of link time pulls any downstream event
        earlier by at most ``s`` — ``stale peek - slack`` therefore
        LOWER-bounds the exact price for ANY flip mix (appears only push
        it up).  The flags are vacuously True (slack 0.0) on None.
        """
        ctx = self.ctx
        placed, assign = self.placed, self.assign
        best: int | None = None
        appear_only = True
        vanish_only = True
        slack = 0.0
        for u in ctx.parents[i]:
            if not placed[u] or assign[u] < 0 or u in ctx.ext:
                continue
            pu = ctx.pos_of.get(u)
            if pu is None or pu >= self.pos:
                continue   # not simulated yet — commits price it later
            a = assign[u]
            if not ctx.has_out[u] or not ctx.has_copy[a]:
                continue   # never stages regardless of consumers
            old = True     # pseudo-sink default
            seen = False
            for c in ctx.children[u]:
                if not placed[c]:
                    continue
                seen = True
                if assign[c] != a:
                    old = True
                    break
            else:
                if seen:
                    old = False
            new = False    # i joins the consumer set, so it is non-empty
            for c in ctx.children[u]:
                ac = j if c == i else (assign[c] if placed[c] else None)
                if ac is not None and ac != a:
                    new = True
                    break
            if old != new:
                if old:
                    appear_only = False   # True -> False: a vanish
                    slack += self.reclaim[u]
                else:
                    vanish_only = False   # False -> True: an appear
                if best is None or pu < best:
                    best = pu
        return best, appear_only, vanish_only, slack


class GraphSimBatch:
    """Price every device move of ONE task in parallel numpy lanes.

    Lane ``l`` simulates the same suffix as a scalar
    ``clone(); assign[mv] = cand[l]; advance(stop)`` walk, but all lanes
    share one clone of the base state: clocks, ``finish``/``avail``/
    ``compute_end`` become ``(L, ·)`` arrays and each engine step applies
    the exact ``_sim_task`` formula elementwise per lane.  Per-lane IEEE
    float64 elementwise ops match the scalar engine op for op, so a lane's
    values are byte-identical to the scalar walk's (pinned by the
    hypothesis suite).

    Only ``mv``'s device varies across lanes, which keeps the per-task
    control flow almost scalar: lanes diverge arithmetically only at
    ``mv`` itself, at tasks reading ``mv`` as a parent, and at producers
    whose host-stage decision depends on ``mv``'s device (the flip case —
    which is why the caller rewinds the base state to the flip floor
    before batching).

    ``run(stop, bound)`` applies the same branch-and-bound rule as
    ``GraphSimState.advance``: a lane whose simulated finish exceeds
    ``bound`` is dead (its final makespan reads +inf); the walk aborts
    once every lane is dead.  Crossover caveat: per-step numpy dispatch
    costs ~3-5x a scalar step, so batching only wins with enough lanes —
    ``optimize._BATCH_MIN_LANES`` gates it (DESIGN.md §14).
    """

    __slots__ = ("ctx", "mv", "cand", "pos", "lanes", "lclock", "dclock",
                 "finish", "compute_end", "avail", "reclaim", "assign",
                 "placed", "alive", "_li", "_npt")

    def __init__(self, base: GraphSimState, mv: int,
                 cand: Sequence[int]):
        ctx = self.ctx = base.ctx
        self.mv = mv
        self.cand = np.array(cand, dtype=np.intp)
        L = self.lanes = len(cand)
        self.pos = base.pos
        self._li = np.arange(L)
        self._npt = ctx.np_tables()
        # resolve carried-over (None) clocks eagerly: link_clock_id is a
        # pure read of ctx.clocks, so this matches the scalar lazy resolve
        self.lclock = np.tile(
            [base.link_clock_id(k) for k in range(len(ctx.link_names))],
            (L, 1))
        self.dclock = np.tile(
            [base.dev_clock_id(j) for j in range(len(ctx.devices))],
            (L, 1))
        self.finish = np.tile(base.finish, (L, 1))
        self.compute_end = np.tile(base.compute_end, (L, 1))
        self.avail = np.tile(base.avail, (L, 1))
        self.reclaim = np.tile(base.reclaim, (L, 1))
        self.assign = base.assign          # scalar; mv's entry is ignored
        self.placed = base.placed
        self.alive = np.ones(L, dtype=bool)

    def run(self, stop: int, bound: float | None = None) -> bool:
        """Advance every lane to ``stop``; False once all lanes are dead
        (their finishes exceeded ``bound``) — surviving lanes are exact."""
        if stop <= self.pos:
            return True
        ctx = self.ctx
        sp = ctx.sim_positions
        lo = bisect.bisect_left(sp, self.pos)
        hi = bisect.bisect_left(sp, stop)
        assign = self.assign
        alive = self.alive
        for idx in range(lo, hi):
            i = ctx.order[sp[idx]]
            if assign[i] >= 0:
                self._sim(i)
                if bound is not None:
                    alive &= self.finish[:, i] <= bound
                    if not alive.any():
                        self.pos = sp[idx] + 1
                        return False
        self.pos = stop
        return True

    def makespans(self) -> np.ndarray:
        """Per-lane makespan over simulated tasks; +inf for dead lanes."""
        ms = self.finish.max(axis=1)
        return np.where(self.alive, ms, np.inf)

    def extract(self, l: int) -> GraphSimState:
        """Lane ``l`` as a scalar ``GraphSimState`` (clocks resolved) —
        adopted as the new head state when the lane's move is accepted."""
        st = GraphSimState.__new__(GraphSimState)
        st.ctx = self.ctx
        st.pos = self.pos
        st.lclock = self.lclock[l].tolist()
        st.dclock = self.dclock[l].tolist()
        st.finish = self.finish[l].tolist()
        st.compute_end = self.compute_end[l].tolist()
        st.avail = self.avail[l].tolist()
        st.reclaim = self.reclaim[l].tolist()
        st.assign = list(self.assign)
        st.assign[self.mv] = int(self.cand[l])
        st.placed = bytearray(self.placed)
        return st

    # -- engine step (exact per-lane _sim_task) ------------------------------

    def _sim(self, i: int) -> None:
        if i == self.mv:
            self._sim_moved(i)
        else:
            self._sim_scalar_dev(i)

    def _sim_scalar_dev(self, i: int) -> None:
        """Task on its committed device ``j`` in every lane; values may
        still lane-vary through clocks/parent avail perturbed by ``mv``."""
        ctx = self.ctx
        mv = self.mv
        j = self.assign[i]
        t = ctx.tasks[i]
        in_lid = ctx.in_lid[j]
        has_copy = ctx.has_copy[j]
        placed = self.placed
        lclock, compute_end, avail = self.lclock, self.compute_end, self.avail

        ready = None
        if has_copy and t.in_bytes > 0.0:
            nd = lclock[:, in_lid] + ctx.ext_in[j][i]
            lclock[:, in_lid] = nd
            ready = nd
        hier = ctx.hier
        host_t, nic_t = ctx.host_id, ctx.nic_dur
        hj = host_t[j] if hier else -1
        par_in = ctx.par_in[j]
        for u in ctx.parents[i]:
            if not placed[u]:
                continue
            if u == mv:
                # producer device lane-varies: the NIC hop applies on
                # lanes whose candidate host differs from j's host
                av = avail[:, u]
                if hier and hj >= 0:
                    hq = self._npt.host[self.cand]
                    crossm = (hq >= 0) & (hq != hj)
                    if crossm.any():
                        av = np.where(crossm, av + nic_t[u], av)
                if not has_copy or not ctx.has_out[u]:
                    same = self.cand == j
                    r = np.where(same, compute_end[:, u], av)
                else:
                    same = self.cand == j
                    s = np.maximum(lclock[:, in_lid], av)
                    nd = s + par_in[u]
                    lclock[:, in_lid] = np.where(same, lclock[:, in_lid],
                                                 nd)
                    r = np.where(same, compute_end[:, u], nd)
            elif self.assign[u] == j:
                r = compute_end[:, u]
            elif not has_copy or not ctx.has_out[u]:
                r = avail[:, u]
                if hier and hj >= 0:
                    q = self.assign[u]
                    if q >= 0 and 0 <= host_t[q] != hj:
                        r = r + nic_t[u]
            else:
                av = avail[:, u]
                if hier and hj >= 0:
                    q = self.assign[u]
                    if q >= 0 and 0 <= host_t[q] != hj:
                        av = av + nic_t[u]
                s = np.maximum(lclock[:, in_lid], av)
                nd = s + par_in[u]
                lclock[:, in_lid] = nd
                r = nd
            ready = r if ready is None else np.maximum(ready, r)

        s = self.dclock[:, j]
        if ready is not None:
            s = np.maximum(s, ready)
        ce = s + ctx.comp[j][i]
        self.dclock[:, j] = ce
        compute_end[:, i] = ce
        self.finish[:, i] = ce
        avail[:, i] = ce
        self.reclaim[:, i] = 0.0

        need = self._need_out_mask(i, j)
        if need is not None:
            out_lid = ctx.out_lid[j]
            prev = lclock[:, out_lid]
            s = np.maximum(prev, ce)
            nd = s + ctx.stage_out[j][i]
            # before the in-place lclock write; inf-prev lanes reclaim 0.0
            # (mirrors the scalar inf - inf guard)
            fin = prev != np.inf
            rec = np.subtract(nd, prev, out=np.zeros_like(nd), where=fin)
            if need is True:
                lclock[:, out_lid] = nd
                avail[:, i] = nd
                self.finish[:, i] = nd
                self.reclaim[:, i] = rec
            else:
                lclock[:, out_lid] = np.where(need, nd, prev)
                avail[:, i] = np.where(need, nd, ce)
                self.finish[:, i] = np.where(need, nd, ce)
                self.reclaim[:, i] = np.where(need, rec, 0.0)

    def _need_out_mask(self, i: int, j: int) -> "bool | np.ndarray | None":
        """``_would_need_out(i, j)`` per lane: None = False everywhere,
        True = every lane, else an (L,) mask (``mv`` is the only consumer
        whose device lane-varies; it always counts as placed)."""
        ctx = self.ctx
        if not ctx.has_out[i] or not ctx.has_copy[j]:
            return None
        placed, assign = self.placed, self.assign
        mv = self.mv
        seen = False
        has_mv = False
        for c in ctx.children[i]:
            if c == mv:
                has_mv = True
                continue
            if not placed[c]:
                continue
            seen = True
            if assign[c] != j:
                return True
        if has_mv:
            # mv counts as a placed consumer, so "no consumers" is off
            # the table; need(l) = mv cross-device in lane l
            mask = self.cand != j
            if mask.all():
                return True
            if not mask.any():
                return None
            return mask
        return None if seen else True

    def _sim_moved(self, i: int) -> None:
        """The moved task itself: device ``cand[l]`` in lane ``l`` — the
        fancy-indexed mirror of ``_sim_task`` (the ``_peek_batch`` idiom,
        committed instead of peeked)."""
        ctx = self.ctx
        npt = self._npt
        t = ctx.tasks[i]
        jv = self.cand
        li = self._li
        in_l = npt.in_lid[jv]
        hc = npt.has_copy[jv]
        placed = self.placed
        lclock, compute_end, avail = self.lclock, self.compute_end, self.avail

        ready = None
        if t.in_bytes > 0.0 and hc.any():
            s = lclock[li, in_l]
            nd = s + npt.ext_in[jv, i]
            lclock[li, in_l] = np.where(hc, nd, s)
            ready = np.where(hc, nd, 0.0)
        hier = ctx.hier
        host_t, nic_t = ctx.host_id, ctx.nic_dur
        hjv = npt.host[jv] if hier else None
        for u in ctx.parents[i]:
            if not placed[u]:
                continue
            same = jv == self.assign[u]
            # consumer device lane-varies: NIC hop on lanes whose host
            # differs from the (scalar) producer's host
            av = avail[:, u]
            if hier:
                q = self.assign[u]
                if q >= 0 and host_t[q] >= 0:
                    crossm = (hjv >= 0) & (hjv != host_t[q])
                    if crossm.any():
                        av = np.where(crossm, av + nic_t[u], av)
            if not ctx.has_out[u]:
                r = np.where(same, compute_end[:, u], av)
            else:
                docopy = ~same & hc
                s = np.maximum(lclock[li, in_l], av)
                nd = s + npt.par_in[jv, u]
                lclock[li, in_l] = np.where(docopy, nd, lclock[li, in_l])
                r = np.where(same, compute_end[:, u],
                             np.where(docopy, nd, av))
            ready = r if ready is None else np.maximum(ready, r)

        s = self.dclock[li, jv]
        if ready is not None:
            s = np.maximum(s, ready)
        ce = s + npt.comp[jv, i]
        self.dclock[li, jv] = ce
        compute_end[:, i] = ce
        self.finish[:, i] = ce
        avail[:, i] = ce
        self.reclaim[:, i] = 0.0

        # stage decision per lane: mv's children have scalar devices
        if ctx.has_out[i]:
            cross = None
            seen = False
            for c in ctx.children[i]:
                if not placed[c]:
                    continue
                seen = True
                cc = jv != self.assign[c]
                cross = cc if cross is None else (cross | cc)
            need = hc if not seen else (hc & cross)
            if need.any():
                out_l = npt.out_lid[jv]
                prev = lclock[li, out_l]   # fancy index: a copy, not a view
                s = np.maximum(prev, ce)
                nd = s + npt.stage_out[jv, i]
                rec = np.subtract(nd, prev, out=np.zeros_like(nd),
                                  where=prev != np.inf)
                lclock[li, out_l] = np.where(need, nd, prev)
                avail[:, i] = np.where(need, nd, ce)
                self.finish[:, i] = np.where(need, nd, ce)
                self.reclaim[:, i] = np.where(need, rec, 0.0)


def _simulate_graph(devices: Sequence[DeviceProfile],
                    tasks: Sequence[TaskSpec],
                    edges: Sequence[tuple[int, int]],
                    assign: Sequence[int], topo: BusTopology,
                    order: Sequence[int],
                    events: list[BusEvent] | None,
                    clocks: ClockState = ZERO_CLOCKS,
                    ext: Mapping[int, tuple[float, float]] | None = None
                    ) -> list[float]:
    """One pass over a task graph's event graph.  Returns per-task finish
    times (0 for tasks with ``assign[i] < 0`` — the list scheduler prices
    partial assignments during device selection); appends ``BusEvent``s
    when ``events`` is a list.

    This is a thin wrapper over ``GraphSimState`` — one fresh state
    advanced over the whole order — so the incremental checkpoint/extend
    path the list scheduler uses and this from-scratch path are the same
    code by construction.

    ``ext`` prices a task *externally* (mid-graph re-planning, DESIGN.md
    §11): a frozen — completed or currently running — task is not
    simulated; its ``(compute_end, avail)`` come from the mapping instead
    (``avail`` = when its output is host-resident; ``math.inf`` marks an
    output that never reaches the host, so any candidate needing a host
    read of it prices to infinity and is rejected by the solver).  Frozen
    tasks emit no events and their finish is reported as their
    ``compute_end``.

    Semantics (the Fig. 2 rules, generalized to precedence edges):

      * ``order`` must be a topological linearization; each link's clock
        advances in that order, so the executor can replay the grant
        sequence without deadlock (a ticket never waits on a later one);
      * a task's external input copy serializes on its device's in-link;
      * a cross-device edge u→v becomes link copies: u's output is staged
        to host once (one ``copy_out`` on u's out-link, shared by all
        cross-device consumers and by the sink return), then each consumer
        reads it over its own in-link (``copy_in`` depending on the stage
        copy's finish, not just the link clock) — same-device edges are
        free (the data never leaves device memory);
      * compute starts at max(device clock, every input landed); no-copy
        devices (the host) read staged data the moment the producer's
        copy_out ends;
      * a sink task's output returns to host after its compute.

    ``clocks`` starts the world from carried-over link/device clocks
    exactly as the divisible engine does, so graph plans chain into the
    streaming runtime unchanged.
    """
    ctx = GraphSimContext(devices, tasks, edges, topo, order, clocks, ext)
    st = GraphSimState(ctx, assign)
    st.advance(len(ctx.order), events)
    return st.finish


def build_graph_timeline(devices: Sequence[DeviceProfile],
                         tasks: Sequence[TaskSpec],
                         edges: Sequence[tuple[int, int]],
                         assign: Sequence[int], *,
                         topology: BusTopology | str | None = None,
                         order: Sequence[int] | None = None,
                         clocks: ClockState = ZERO_CLOCKS,
                         ext: Mapping[int, tuple[float, float]] | None = None
                         ) -> Timeline:
    """The unified event-graph timeline for a task graph — what the list
    scheduler prices, ``simulate_graph_timeline`` returns, and the
    executor's per-link ticket order is derived from.  ``ext`` freezes
    tasks out of the simulation (mid-graph re-planning): they emit no
    events and feed consumers at the given (compute_end, avail) times."""
    topo = BusTopology.from_spec(topology, devices)
    if order is None:
        order = _graph_topo_order(len(tasks), edges)
    events: list[BusEvent] = []
    _simulate_graph(devices, tasks, edges, assign, topo, order, events,
                    clocks, ext)
    return Timeline(events)


def graph_finish_times(devices: Sequence[DeviceProfile],
                       tasks: Sequence[TaskSpec],
                       edges: Sequence[tuple[int, int]],
                       assign: Sequence[int], *,
                       topology: BusTopology | str | None = None,
                       order: Sequence[int] | None = None,
                       clocks: ClockState = ZERO_CLOCKS,
                       ext: Mapping[int, tuple[float, float]] | None = None
                       ) -> list[float]:
    """Per-task finish times from the same control flow as
    ``build_graph_timeline``, without materializing events (the list
    scheduler's device-selection hot path)."""
    topo = BusTopology.from_spec(topology, devices)
    if order is None:
        order = _graph_topo_order(len(tasks), edges)
    return _simulate_graph(devices, tasks, edges, assign, topo, order, None,
                           clocks, ext)


@dataclasses.dataclass(frozen=True)
class GraphTimelineSpec:
    """The engine inputs a task-graph ``Schedule``'s timeline was built
    from — the DAG analogue of ``TimelineSpec``, same contract: a runtime
    can rebase the identical event graph onto carried-over clocks, or
    re-price it under ground-truth device models, without knowing any
    domain geometry.  ``order`` is the planned (topological) priority list;
    replays must keep it, or the executor's ticket grant order would
    diverge from the plan."""

    devices: tuple[DeviceProfile, ...]
    tasks: tuple[TaskSpec, ...]
    edges: tuple[tuple[int, int], ...]
    assign: tuple[int, ...]
    order: tuple[int, ...]
    topology: BusTopology

    def rebase(self, clocks: ClockState = ZERO_CLOCKS, *,
               devices: Sequence[DeviceProfile] | None = None) -> Timeline:
        devs = list(devices) if devices is not None else list(self.devices)
        return build_graph_timeline(devs, self.tasks, self.edges,
                                    self.assign, topology=self.topology,
                                    order=self.order, clocks=clocks)

    def rebase_partial(self, clocks: ClockState = ZERO_CLOCKS, *,
                       ext: Mapping[str, tuple[float, float]],
                       devices: Sequence[DeviceProfile] | None = None
                       ) -> Timeline:
        """Partial rebase for mid-graph re-planning (DESIGN.md §11): price
        only the remaining subgraph from the carried (measured) clocks.
        ``ext`` maps *frozen task names* — completed or currently running —
        to ``(compute_end, avail)``: those tasks emit no events; frontier
        consumers read them at the given times (``avail = math.inf`` marks
        an output that never reaches the host).  The returned timeline
        holds exactly the frontier's events — its ``link_ticket_order`` is
        what the executor re-issues."""
        devs = list(devices) if devices is not None else list(self.devices)
        index = {t.name: i for i, t in enumerate(self.tasks)}
        return build_graph_timeline(
            devs, self.tasks, self.edges, self.assign,
            topology=self.topology, order=self.order, clocks=clocks,
            ext={index[name]: t for name, t in ext.items()})

    def ops_by_device(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for t, a in zip(self.tasks, self.assign):
            if a >= 0:
                name = self.devices[a].name
                out[name] = out.get(name, 0.0) + float(t.ops)
        return out

    def task_ops(self) -> list[tuple[str, str, float]]:
        """(task, device, ops) per scheduled task — the per-task
        observation surface the streaming runtime pumps back into the
        Predict phase."""
        return [(t.name, self.devices[a].name, float(t.ops))
                for t, a in zip(self.tasks, self.assign) if a >= 0]

    def parents_of(self) -> dict[str, tuple[str, ...]]:
        """Task name -> upstream task names (the executor's cross-device
        dependency wait list)."""
        out: dict[str, list[str]] = {t.name: [] for t in self.tasks}
        for u, v in self.edges:
            out[self.tasks[v].name].append(self.tasks[u].name)
        return {k: tuple(v) for k, v in out.items()}

    def stage_seconds(self, devices: Sequence[DeviceProfile] | None = None
                      ) -> dict[str, dict[str, float]]:
        """Per-task summed stage durations (``{task: {kind: seconds}}``)
        under ``devices`` (default: the planned models) — what a sleep-based
        task factory prices its stages from."""
        tl = self.rebase(devices=devices)
        out: dict[str, dict[str, float]] = {}
        for e in tl.events:
            if e.task is None:  # pragma: no cover - graph events carry tasks
                continue
            kinds = out.setdefault(e.task, {})
            kinds[e.kind] = kinds.get(e.kind, 0.0) + e.duration
        return out
