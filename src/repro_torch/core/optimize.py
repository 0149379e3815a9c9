"""POAS phase 2 — *Optimize*.

The paper formulates work division as a MILP (Eqs. 1–3): minimize the
makespan ``max_x(t_c(c_x) + t_y(c_x))`` subject to ``Σ c_x = N``, ``c_x ≥ 0``
and solves it with CPLEX.  CPLEX is unavailable here; the problem class is
small (a handful of devices) and the per-device time models are monotone
non-decreasing in ``c_x``, so we replace the external solver with:

* ``solve_bisection`` — exact for *any* monotone time model (subsumes the
  paper's linear MILP): bisect on the makespan T; feasibility is "can the
  devices jointly absorb N ops, each finishing by T?", which decomposes
  per-device on uncontended topologies.  On contended topologies (the
  paper's serialized shared bus, §3.4.3/Fig. 2) the greedy priority-ordered
  feasibility check prices every candidate against the *exact* unified
  timeline engine (``core.bus``) — including chunked pipelined copies — so
  the solver optimizes precisely what the simulator reports and the
  executor replays.
* ``solve_analytic`` — closed-form active-set LP for the linear,
  independent-bus case (for cross-checking, and it is what a CPLEX run of
  Eqs. 1–4 returns).
* ``solve_local_search`` — CSP fallback for arbitrary (non-convex) models,
  per the paper's §3.2 note that backtracking/local search handles models
  that are not linear/quadratic.
* ``solve_list_schedule`` — the task-graph solver (DESIGN.md §10): the
  divisible-workload MILP does not apply to precedence-constrained DAGs,
  so work division becomes *device selection per task* — a HEFT-style list
  scheduler (upward-rank priority, earliest-finish-time placement) whose
  every candidate is priced on the same unified timeline engine, refined
  by reassignment descent (the discrete analogue of ``_descend``) or, on
  small instances, replaced outright by exhaustive enumeration.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import threading
from collections import OrderedDict
from typing import Mapping, Sequence

import numpy as np

from .bus import (BusTopology, ClockState, GraphSimBatch, GraphSimContext,
                  GraphSimState, TaskSpec, ZERO_CLOCKS, _graph_topo_order,
                  engine_finish_times, graph_finish_times)
from .device_model import DeviceProfile, LinearTimeModel, priority_order

_EPS = 1e-12
_TINY = 1e-30   # probe op count: prices fixed costs (B panel, launch) only


@dataclasses.dataclass
class OptimizeResult:
    ops: list[float]                 # c_x per device (Σ = N)
    makespan: float                  # predicted total time
    finish_times: list[float]        # per-device predicted finish
    bus: str                         # "independent" | "serialized" | custom
    iterations: int = 0
    energy_j: float | None = None    # joules, when an Objective was given

    def shares(self) -> list[float]:
        n = sum(self.ops)
        return [c / n if n else 0.0 for c in self.ops]


@dataclasses.dataclass(frozen=True)
class Objective:
    """Pluggable solver objective (DESIGN.md §16).

    ``score = makespan + energy_weight * energy_joules`` — the knob
    ``energy_weight`` is *seconds per joule*: 0 recovers the paper's pure
    makespan objective (selection stays bit-identical to the pre-objective
    solvers, regression-tested), +inf-ward trades latency for energy.
    Energy is priced post-hoc from the device power models
    (``DeviceProfile.idle_watts`` / ``joules_per_op``) over the engine's
    per-device busy/idle split, so the timing hot paths never change.
    """

    energy_weight: float = 0.0

    @property
    def is_makespan(self) -> bool:
        return self.energy_weight <= 0.0

    def score(self, makespan: float, energy_j: float) -> float:
        if self.energy_weight <= 0.0:
            return makespan
        return makespan + self.energy_weight * energy_j


MAKESPAN_OBJECTIVE = Objective(0.0)


def divisible_energy(devices: Sequence[DeviceProfile],
                     ops: Sequence[float], makespan: float) -> float:
    """Energy of a divisible-workload split: per-device dynamic joules for
    the MACs executed plus idle watts over the schedule gap."""
    e = 0.0
    for d, c in zip(devices, ops):
        busy = d.compute(float(c)) if c > 0.0 else 0.0
        if busy > makespan:
            busy = makespan
        e += d.joules_per_op * float(c) + d.idle_watts * (makespan - busy)
    return e


def _graph_energy_parts(ctx: GraphSimContext, assign: Sequence[int]
                        ) -> tuple[list[float], float]:
    """``(per-device busy seconds, dynamic joules)`` of a (partial) graph
    assignment — from the same per-(device, task) compute table the engine
    prices, so energy and timing share one source of truth.  Frozen
    (``ext``) tasks ran outside this plan and are excluded."""
    devices, comp, tasks, ext = ctx.devices, ctx.comp, ctx.tasks, ctx.ext
    busy = [0.0] * len(devices)
    dyn = 0.0
    for i in range(ctx.n):
        j = assign[i]
        if j >= 0 and i not in ext:
            busy[j] += comp[j][i]
            dyn += devices[j].joules_per_op * float(tasks[i].ops)
    return busy, dyn


def graph_energy(ctx: GraphSimContext, assign: Sequence[int],
                 makespan: float) -> float:
    """Total joules of a graph schedule under the device power models."""
    busy, dyn = _graph_energy_parts(ctx, assign)
    idle = 0.0
    for d, b in zip(ctx.devices, busy):
        if d.idle_watts > 0.0:
            gap = makespan - b
            if gap > 0.0:
                idle += d.idle_watts * gap
    return dyn + idle


# ---------------------------------------------------------------------------
# Feasibility: how many ops can each device absorb within makespan T?
# Both checks price candidates on the unified timeline engine, so the
# solver, the simulator, and the executor share one source of truth.
# ---------------------------------------------------------------------------


def _max_ops_single(devices: Sequence[DeviceProfile], i: int, T: float,
                    n: int, k: int, topo: BusTopology,
                    order: Sequence[int], N: float) -> float:
    """Largest c_i with device i's engine finish <= T, no contention."""
    c = [0.0] * len(devices)

    def fin(ci: float) -> float:
        c[i] = ci
        return engine_finish_times(devices, c, n, k, topology=topo,
                                   order=order)[i]

    if fin(_TINY) > T:      # fixed costs alone (B panel, launch) miss T
        return 0.0
    if fin(float(N)) <= T:  # the whole workload fits
        return float(N)
    lo, hi = 0.0, float(N)
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if fin(mid) <= T:
            lo = mid
        else:
            hi = mid
        if hi - lo <= max(1.0, lo) * 1e-9:
            break
    return lo


def _max_ops_serialized(devices: Sequence[DeviceProfile], order: Sequence[int],
                        T: float, n: int, k: int, topo: BusTopology,
                        N: float) -> list[float]:
    """Greedy priority-ordered assignment under a contended topology.

    Device i's candidate c_i is the largest value keeping the *whole*
    partial timeline's makespan within T — evaluated on the exact engine,
    so queueing on every link, compute overlap, no-copy devices starting at
    t = 0, and pipelined chunk boundaries are all priced exactly (the old
    linearized check both over-charged no-copy devices for bus time they
    never wait on and let output copies overlap input copies).  The engine
    makespan is monotone in every c_i, so greedy-max in priority order
    maximizes the total absorbed ops for a given T.
    """
    c = [0.0] * len(devices)
    for i in order:

        def span(ci: float) -> float:
            c[i] = ci
            return max(engine_finish_times(devices, c, n, k, topology=topo,
                                           order=order))

        if span(_TINY) > T:
            c[i] = 0.0
            continue
        if span(float(N)) <= T:
            c[i] = float(N)
            continue
        lo, hi = 0.0, float(N)
        for _ in range(100):
            mid = 0.5 * (lo + hi)
            if span(mid) <= T:
                lo = mid
            else:
                hi = mid
            if hi - lo <= max(1.0, lo) * 1e-9:
                break
        c[i] = lo
    return c


# ---------------------------------------------------------------------------
# Exact bisection solver
# ---------------------------------------------------------------------------


def solve_bisection(devices: Sequence[DeviceProfile], N: float, *,
                    n: int, k: int,
                    bus: str | BusTopology = "independent",
                    tol: float = 1e-9, polish: bool = True,
                    objective: Objective | None = None) -> OptimizeResult:
    """Minimize makespan by bisecting on T.

    ``bus`` is a legacy spec string ("independent" | "serialized") or a
    ``BusTopology``.  Feasibility prices every candidate on the exact
    unified timeline engine, so the check is exact for any topology and for
    chunked pipelined copies; the contended-topology result is additionally
    *polished* by coordinate descent on the same engine (the greedy
    priority-ordered assignment is not always the global optimum).

    ``objective``: with a pure-makespan objective (None / weight 0) the
    selection is exactly the historical one; an energy-weighted objective
    re-scores the makespan-optimal split against every device-*subset*
    split (spreading work burns idle+dynamic joules on every device it
    touches — the energy optimum often parks the workload on fewer,
    more efficient devices) and returns the best ``score``.
    """
    spec = bus.spec if isinstance(bus, BusTopology) else bus
    if N <= 0:
        z = [0.0] * len(devices)
        return OptimizeResult(z, 0.0, z, spec)
    topo = BusTopology.from_spec(bus, devices)
    order = priority_order(devices)
    contended = topo.is_contended()

    def capacity(T: float) -> list[float]:
        if contended:
            return _max_ops_serialized(devices, order, T, n, k, topo, N)
        return [_max_ops_single(devices, i, T, n, k, topo, order, N)
                for i in range(len(devices))]

    # bracket: every single-device assignment is feasible at its own engine
    # makespan; on a contended topology the greedy may interleave devices,
    # so the safe upper bound is the serial sum of those makespans.
    def single(i: int) -> float:
        one = [0.0] * len(devices)
        one[i] = N
        return max(engine_finish_times(devices, one, n, k, topology=topo,
                                       order=order))

    singles = [single(i) for i in range(len(devices))]
    t_lo = 0.0
    t_hi = sum(singles) if contended else min(singles)
    iters = 0
    for _ in range(200):
        iters += 1
        mid = 0.5 * (t_lo + t_hi)
        if sum(capacity(mid)) >= N:
            t_hi = mid
        else:
            t_lo = mid
        if t_hi - t_lo <= max(tol, t_hi * 1e-10):
            break
    caps = capacity(t_hi)
    total = sum(caps)
    # Scale back surplus so Σ c = N exactly, preferring to trim the devices
    # with the largest marginal cost (keeps the makespan at T*).
    if total > 0:
        scale = N / total
        ops = [c * scale for c in caps]
    else:  # pragma: no cover - degenerate
        ops = [N / len(devices)] * len(devices)
    if polish and contended and len(devices) > 1:
        ops = _descend(devices, ops, n, k, topo, order,
                       step0=N / 64.0, max_evals=1500)
    finish = _finish_times(devices, ops, n, k, topo, order)
    best = OptimizeResult(ops, max(finish), finish, spec, iterations=iters)
    # Degenerate single-device assignments are feasible points the split
    # can lose to on small workloads (copy overheads don't amortize — the
    # paper's §3.4.3 "significant amount of work" caveat).  Take the min.
    for i in range(len(devices)):
        one = [0.0] * len(devices)
        one[i] = N
        f1 = _finish_times(devices, one, n, k, topo, order)
        if max(f1) < best.makespan:
            best = OptimizeResult(one, max(f1), f1, spec, iterations=iters)
    if objective is None:
        return best
    best.energy_j = divisible_energy(devices, best.ops, best.makespan)
    if objective.is_makespan or len(devices) <= 1:
        return best
    # energy mode: re-score against every proper device-subset split —
    # each subset solved makespan-optimally by the exact machinery above,
    # then priced with the idle watts of the devices it left out
    best_score = objective.score(best.makespan, best.energy_j)
    m = len(devices)
    for mask in range(1, (1 << m) - 1):
        idxs = [i for i in range(m) if mask >> i & 1]
        sub = [devices[i] for i in idxs]
        r = solve_bisection(sub, N, n=n, k=k,
                            bus=bus if isinstance(bus, BusTopology)
                            else spec, tol=tol, polish=polish)
        ops_full = [0.0] * m
        for i, c in zip(idxs, r.ops):
            ops_full[i] = c
        e = divisible_energy(devices, ops_full, r.makespan)
        s = objective.score(r.makespan, e)
        if s < best_score - _EPS:
            fin_full = [0.0] * m
            for i, f in zip(idxs, r.finish_times):
                fin_full[i] = f
            best = OptimizeResult(ops_full, r.makespan, fin_full, spec,
                                  iterations=iters + r.iterations,
                                  energy_j=e)
            best_score = s
    return best


def _descend(devices: Sequence[DeviceProfile], ops0: Sequence[float],
             n: int, k: int, bus: str | BusTopology, order: Sequence[int], *,
             step0: float, max_evals: int) -> list[float]:
    """Pairwise-transfer coordinate descent on the exact timeline makespan."""
    ops = list(ops0)
    m = len(devices)

    def makespan(v):
        return max(_finish_times(devices, v, n, k, bus, order))

    best = makespan(ops)
    step = step0
    evals = 0
    while step > sum(ops0) * 1e-10 and evals < max_evals:
        improved = False
        for src in range(m):
            if ops[src] <= 0:
                continue
            for dst in range(m):
                if src == dst:
                    continue
                delta = min(step, ops[src])
                cand = list(ops)
                cand[src] -= delta
                cand[dst] += delta
                t = makespan(cand)
                evals += 1
                if t < best - _EPS:
                    ops, best, improved = cand, t, True
        if not improved:
            step *= 0.5
    return ops


def _finish_times(devices: Sequence[DeviceProfile], ops: Sequence[float],
                  n: int, k: int, bus: str | BusTopology,
                  order: Sequence[int] | None = None) -> list[float]:
    """Per-device finish times — the unified engine, nothing else.

    This used to be an independent re-implementation of the Fig. 2 timeline
    that (a) charged no-copy devices for bus queue time they never wait on
    and (b) reset the output-copy clock to 0, letting outputs overlap
    inputs on the supposedly serialized bus; both made the solver optimize
    a different objective than ``simulate_timeline`` measured.  Delegating
    to ``engine_finish_times`` makes solver/simulator agreement exact by
    construction."""
    return engine_finish_times(devices, ops, n, k, topology=bus, order=order)


# ---------------------------------------------------------------------------
# Analytic LP (linear models, independent bus)
# ---------------------------------------------------------------------------


def solve_analytic(devices: Sequence[DeviceProfile], N: float, *,
                   n: int, k: int) -> OptimizeResult:
    """Closed-form: at the optimum all devices with c_x>0 finish together.

    With linear t_x(c) = α_x c + β_x (α folds compute+copy slopes, β the
    intercepts), equalizing finish times gives
        T* = (N + Σ β_x/α_x) / (Σ 1/α_x)
    over the active set; devices whose β_x ≥ T* are dropped iteratively.

    Zero-slope devices (``LinearTimeModel(a=0, b=...)`` — constant time
    regardless of load) would divide by zero in the LP; they are held out
    of the active set and compared as "hand it everything" candidates
    (a zero-slope device finishes at β no matter how much it absorbs).
    """
    alphas, betas = [], []
    for d in devices:
        t0 = d.total_time(0.0, n, k)
        t1 = d.total_time(1e9, n, k)
        alphas.append((t1 - t0) / 1e9)
        betas.append(t0)
    zero = [i for i in range(len(devices)) if alphas[i] <= 0.0]
    active = [i for i in range(len(devices)) if alphas[i] > 0.0]
    T = math.inf
    if active:
        while True:
            num = N + sum(betas[i] / alphas[i] for i in active)
            den = sum(1.0 / alphas[i] for i in active)
            T = num / den
            drop = [i for i in active if betas[i] >= T - _EPS]
            if not drop:
                break
            active = [i for i in active if i not in drop]
            if not active:
                T = math.inf
                break
    if zero:
        j = min(zero, key=lambda i: betas[i])
        if betas[j] <= T:   # constant-time device beats (or is) the LP
            ops = [0.0] * len(devices)
            ops[j] = N
            finish = _finish_times(devices, ops, n, k, "independent")
            return OptimizeResult(ops, max(finish), finish, "independent")
    if not active:  # pragma: no cover
        raise RuntimeError("no device can make progress")
    ops = [0.0] * len(devices)
    for i in active:
        ops[i] = (T - betas[i]) / alphas[i]
    # normalize tiny numerical drift
    s = sum(ops)
    ops = [c * (N / s) for c in ops]
    finish = _finish_times(devices, ops, n, k, "independent")
    return OptimizeResult(ops, max(finish), finish, "independent")


# ---------------------------------------------------------------------------
# Local-search CSP fallback (paper §3.2: non-linear models)
# ---------------------------------------------------------------------------


def solve_local_search(devices: Sequence[DeviceProfile], N: float, *,
                       n: int, k: int, bus: str | BusTopology = "independent",
                       iters: int = 4000, seed: int = 0) -> OptimizeResult:
    """Coordinate-descent on op shares.  Works for arbitrary monotone models;
    used as a CSP-style fallback and as an independent check of bisection."""
    import numpy as np
    rng = np.random.default_rng(seed)
    m = len(devices)
    bus = BusTopology.from_spec(bus, devices)
    order = priority_order(devices)

    def makespan(ops):
        return max(_finish_times(devices, list(ops), n, k, bus, order))

    ops = np.full(m, N / m)
    best = makespan(ops)
    step = N / 4.0
    it = 0
    while step > N * 1e-9 and it < iters:
        improved = False
        for src in range(m):
            for dst in range(m):
                if src == dst or ops[src] <= 0:
                    continue
                delta = min(step, ops[src])
                cand = ops.copy()
                cand[src] -= delta
                cand[dst] += delta
                t = makespan(cand)
                it += 1
                if t < best - _EPS:
                    ops, best, improved = cand, t, True
        if not improved:
            step *= 0.5
    finish = _finish_times(devices, list(ops), n, k, bus, order)
    return OptimizeResult(list(ops), max(finish), finish, bus.spec,
                          iterations=it)


# ---------------------------------------------------------------------------
# HEFT-style list scheduler for task graphs (DESIGN.md §10)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphScheduleResult(OptimizeResult):
    """``OptimizeResult`` plus the task-graph solution: which device each
    task runs on (``assign``), the topological priority list the links are
    serialized in (``order``), and per-task predicted finish times.  The
    inherited ``ops`` are per-device op totals, so share-based consumers
    (dynamic load shedding asserts, dashboards) work unchanged."""

    assign: list[int] = dataclasses.field(default_factory=list)
    order: list[int] = dataclasses.field(default_factory=list)
    task_finish: list[float] = dataclasses.field(default_factory=list)


def _upward_ranks(devices: Sequence[DeviceProfile],
                  tasks: Sequence[TaskSpec],
                  edges: Sequence[tuple[int, int]]) -> list[float]:
    """HEFT upward rank: mean compute cost plus the most expensive
    downstream chain, edges priced at the mean staged-transfer cost.
    Device-independent, so the priority list is fixed before placement.

    Vectorized: ``wbar``/``cbar`` are per-task numpy arrays accumulated
    device-by-device in the same order the scalar ``sum`` ran, and the
    downstream recurrence runs level-synchronously with per-level CSR
    child arrays and ``np.maximum.reduceat``.  Every float operation
    keeps the sequential version's order and grouping, so the ranks —
    and therefore the priority list — are bit-identical to it (max is
    exact, and ``max_c(cbar + rank_c) == cbar + max_c(rank_c)`` because
    IEEE addition is monotone)."""
    n = len(tasks)
    children: list[list[int]] = [[] for _ in range(n)]
    for u, v in edges:
        children[u].append(v)
    ops = np.array([float(t.ops) for t in tasks])
    out_b = np.array([float(t.out_bytes) for t in tasks])

    acc = np.zeros(n)
    for d in devices:
        tm = d.compute
        if isinstance(tm, LinearTimeModel):
            acc = acc + (tm.a * ops + tm.b)
        else:   # nonlinear model: per-task calls, same accumulation order
            acc = acc + np.array([tm(t.ops) for t in tasks])
    wbar = acc / len(devices)

    copiers = [d for d in devices
               if not math.isinf(d.copy.bandwidth_bytes_per_s)]
    if copiers:
        cacc = np.zeros(n)
        for d in copiers:
            cacc = cacc + (2.0 * out_b / d.copy.bandwidth_bytes_per_s
                           + d.copy.latency_s)
        cbar = np.where(out_b > 0.0, cacc / len(copiers), 0.0)
    else:
        cbar = np.zeros(n)

    # level-synchronous recurrence over the reversed topological order:
    # level 0 = leaves (tail 0), level L depends only on levels < L
    level = [0] * n
    for i in reversed(_graph_topo_order(n, edges)):
        if children[i]:
            level[i] = 1 + max(level[c] for c in children[i])
    rank = wbar.copy()   # leaves: rank = wbar
    by_level: dict[int, list[int]] = {}
    for i in range(n):
        if level[i] > 0:
            by_level.setdefault(level[i], []).append(i)
    for lv in sorted(by_level):
        nodes = by_level[lv]
        kids = [c for i in nodes for c in children[i]]
        offs = np.cumsum([0] + [len(children[i]) for i in nodes])[:-1]
        maxchild = np.maximum.reduceat(rank[kids], offs)
        nd = np.array(nodes)
        rank[nd] = wbar[nd] + (cbar[nd] + maxchild)
    return rank.tolist()


def _rank_order(devices: Sequence[DeviceProfile], tasks: Sequence[TaskSpec],
                edges: Sequence[tuple[int, int]]) -> list[int]:
    """Decreasing upward rank, ties broken by topological position (so the
    order is always a valid linearization even under zero-cost ties)."""
    topo_pos = {i: p for p, i in
                enumerate(_graph_topo_order(len(tasks), edges))}
    rank = _upward_ranks(devices, tasks, edges)
    return sorted(range(len(tasks)), key=lambda i: (-rank[i], topo_pos[i]))


# -- incremental EFT machinery (DESIGN.md §12, §14) -------------------------

_SNAP_EVERY = 24   # order positions between simulation-state snapshots
_PEEK_BATCH_MIN_DEVS = 6    # below this, d scalar peeks beat the numpy lanes
_BATCH_MIN_LANES = 4        # GraphSimBatch lanes needed to beat scalar walks
_PRUNE_MIN_MOVABLE = 48     # full descent sweeps below this many movables
_PRUNE_TAIL = 24            # latest-finishing movables kept by the pruner


class _SnapChain:
    """Block-keyed snapshot chain under a moving head state (DESIGN.md §14).

    Snapshots are ``GraphSimState`` clones keyed by ``pos // _SNAP_EVERY``,
    recorded as the head advances (``advance_snapped``) and invalidated
    above a flip/move position when an accepted candidate rewrites history
    (``invalidate_above``).  ``state_at(m)`` resumes from the nearest
    recorded block at or below ``m``: *adoption* — a priced re-simulation
    becoming the new head instead of being re-simulated a second time —
    leaves gaps in the chain, and the engine's ``sim_positions`` bisect
    makes re-advancing across a gap cost only the simulated (non-frozen)
    tasks inside it, so tolerating gaps is cheaper than eagerly re-recording
    clones (an O(n) copy each) ever was."""

    __slots__ = ("snaps", "min_key")

    def __init__(self, min_key: int = 0):
        self.snaps: dict[int, GraphSimState] = {}
        self.min_key = min_key

    def advance_snapped(self, st: GraphSimState, stop: int) -> None:
        """Advance the head to ``stop``, recording a clone at every
        ``_SNAP_EVERY`` boundary crossed at or above ``min_key`` (descent
        never rewinds below the earliest movable task or movable-task
        parent, so snapshots under that floor would be dead weight)."""
        while st.pos < stop:
            nxt = (st.pos // _SNAP_EVERY + 1) * _SNAP_EVERY
            if nxt > stop:
                nxt = stop
            st.advance(nxt)
            if nxt % _SNAP_EVERY == 0 and nxt // _SNAP_EVERY >= self.min_key:
                self.snaps[nxt // _SNAP_EVERY] = st.snap_clone()

    def state_at(self, m: int, assign: list[int],
                 placed: bytearray) -> GraphSimState:
        """A throwaway state resumed from the nearest block <= ``m``,
        carrying the caller's *live* assign/placed lists (the snapshots'
        own copies are stale by design).

        When adoption has left a gap below ``m``, the catch-up advance
        repairs the chain by recording the missing boundary clones.
        Every caller's candidate world diverges from the committed
        trajectory only at or after ``m * _SNAP_EVERY`` (``m`` is the
        block of the earliest flip/move position), so the blocks crossed
        here simulate identically in both worlds and are valid committed
        snapshots — without this, one far-back adoption wipes the chain
        and every later resume replays the same gap again."""
        k = m if m in self.snaps else max(k for k in self.snaps if k <= m)
        tmp = self.snaps[k].snap_clone()
        tmp.assign = assign
        tmp.placed = placed
        while k < m:
            k += 1
            tmp.advance(k * _SNAP_EVERY)
            self.snaps[k] = tmp.snap_clone()
        return tmp

    def invalidate_above(self, m: int) -> None:
        """Drop blocks simulated past the rewrite point — block ``b`` is
        still valid iff its boundary ``b * _SNAP_EVERY`` <= the rewrite
        position, i.e. ``b <= m``."""
        for k in [k for k in self.snaps if k > m]:
            del self.snaps[k]


def _resim_place(st: GraphSimState, chain: _SnapChain, pos: int, i: int,
                 j: int, fp: int) -> tuple[GraphSimState, float]:
    """Exact price of candidate ``(i, j)`` whose placement flips an earlier
    producer's host-stage decision: re-simulate positions [snapshot, pos]
    on a throwaway state under the tentative assignment.  Returns the
    re-simulated state too — if the lane wins, the caller *adopts* it as
    the new head instead of re-simulating the same span a second time
    (the old rewind-and-re-advance commit)."""
    old_a, old_p = st.assign[i], st.placed[i]
    st.assign[i] = j
    st.placed[i] = 1
    tmp = chain.state_at(fp // _SNAP_EVERY, st.assign, st.placed)
    tmp.advance(pos + 1)
    st.assign[i] = old_a
    st.placed[i] = old_p
    return tmp, tmp.finish[i]


class _DeviceArrays:
    """Per-solve device constants for the vectorized EFT candidate batch —
    the context's per-(device, task) duration tables as (d, n) numpy
    arrays plus per-device masks, one lane per candidate device."""

    __slots__ = ("idx", "has_copy", "ext_in", "par_in", "stage_out", "comp",
                 "same_link", "hier", "host", "nic_dur")

    def __init__(self, ctx: GraphSimContext):
        npt = ctx.np_tables()   # built once per graph, shared by rebind
        self.idx = npt.idx
        self.has_copy = npt.has_copy
        self.ext_in = npt.ext_in
        self.par_in = npt.par_in
        self.stage_out = npt.stage_out
        self.comp = npt.comp
        self.same_link = npt.same_link
        self.hier = npt.hier
        self.host = npt.host
        self.nic_dur = npt.nic_dur


def _peek_batch(st: GraphSimState, da: _DeviceArrays, i: int) -> np.ndarray:
    """Vectorized ``GraphSimState.peek_finish`` over every device at once.

    Each numpy lane applies the identical float operations in the
    identical order to the scalar path (durations come from the shared
    per-(device, task) tables; elementwise IEEE double ops match Python
    floats exactly), so device selection sees bit-identical finish times —
    asserted transitively by the incremental-vs-from-scratch equality
    checks in the bench and the property tests."""
    ctx = st.ctx
    t = ctx.tasks[i]
    nd = len(ctx.devices)
    lc = np.array([st.link_clock_id(lid) for lid in ctx.in_lid])
    dev_clk = np.array([st.dev_clock_id(j) for j in range(nd)])
    touched = np.zeros(nd, dtype=bool)   # lanes whose in-link clock moved
    ready = np.zeros(nd)

    if t.in_bytes > 0.0:
        end = lc + da.ext_in[:, i]
        lc = np.where(da.has_copy, end, lc)
        touched = touched | da.has_copy
        ready = np.where(da.has_copy, end, ready)

    placed, assign = st.placed, st.assign
    hier, host_t = ctx.hier, ctx.host_id
    for u in ctx.parents[i]:
        if not placed[u]:
            continue
        same = da.idx == assign[u]
        ce_u, av_u = st.compute_end[u], st.avail[u]
        if hier:
            # cross-host lanes read the producer's staged output one NIC
            # hop late (mirrors the scalar peek_finish)
            q = assign[u]
            if q >= 0 and host_t[q] >= 0:
                crossm = (da.host >= 0) & (da.host != host_t[q])
                if crossm.any():
                    av_u = np.where(crossm, av_u + da.nic_dur[u], av_u)
        if not ctx.has_out[u]:
            r = np.where(same, ce_u, av_u)
        else:
            s = np.maximum(lc, av_u)
            end = s + da.par_in[:, u]
            copy_lane = da.has_copy & ~same
            lc = np.where(copy_lane, end, lc)
            touched = touched | copy_lane
            r = np.where(same, ce_u, np.where(da.has_copy, end, av_u))
        ready = np.maximum(ready, r)

    s = np.maximum(dev_clk, ready)
    ce = s + da.comp[:, i]

    if not ctx.has_out[i]:
        return ce
    kids = [c for c in ctx.children[i] if placed[c]]
    if kids:
        ka = np.array([assign[c] for c in kids])
        need = da.has_copy & (ka[None, :] != da.idx[:, None]).any(axis=1)
    else:
        need = da.has_copy.copy()   # pseudo-sink: output returns to host
    out_clk = np.array([st.link_clock_id(lid) for lid in ctx.out_lid])
    out_clk = np.where(da.same_link & touched, lc, out_clk)
    s2 = np.maximum(out_clk, ce)
    return np.where(need, s2 + da.stage_out[:, i], ce)


def _eft_place(ctx: GraphSimContext, assign: Sequence[int],
               pinned: Mapping[int, int],
               banned: frozenset[int] | None = None
               ) -> tuple[GraphSimState, int]:
    """Rank-priority EFT placement on the incremental engine: one
    ``GraphSimState`` swept along the priority order, each (task, device)
    candidate priced by the vectorized peek in O(deg·d) — falling back to
    a snapshot re-simulation only when the candidate flips an earlier
    producer's host-stage decision (DESIGN.md §12).  Selection and
    resulting assignments are bit-identical to pricing every prefix from
    scratch; returns the final state, the candidate-evaluation count, and
    the snapshot chain (which a following descent can adopt via ``init``
    instead of rebuilding state and snapshots from scratch).
    """
    ndev = len(ctx.devices)
    st = GraphSimState(ctx, assign, placed=list(ctx.ext))
    sp = ctx.sim_positions
    chain = _SnapChain(sp[0] // _SNAP_EVERY if sp else 0)
    if chain.min_key == 0:
        chain.snaps[0] = st.snap_clone()
    use_batch = ndev >= _PEEK_BATCH_MIN_DEVS
    da = _DeviceArrays(ctx) if use_batch else None
    evals = 0

    def commit(stc: GraphSimState, pos: int, i: int, j: int,
               fp: int | None) -> GraphSimState:
        stc.assign[i] = j
        stc.placed[i] = 1
        if fp is not None:
            stc = chain.state_at(fp // _SNAP_EVERY, stc.assign, stc.placed)
            chain.invalidate_above(fp // _SNAP_EVERY)
        chain.advance_snapped(stc, pos + 1)
        return stc

    # a partial solve's order is mostly pinned∩ext positions — pure no-ops
    # (frozen AND externally priced); enumerate only the ones with work
    ext = ctx.ext
    if pinned:
        work = [(pos, i) for pos, i in enumerate(ctx.order)
                if i not in pinned or i not in ext]
    else:
        work = enumerate(ctx.order)
    for pos, i in work:
        if i in pinned:
            if i not in ctx.ext:   # frozen assignment still gets simulated
                st = commit(st, pos, i, st.assign[i],
                            st.stage_flip_pos(i, st.assign[i]))
            continue
        if i in ctx.ext:
            # finish is fixed externally: every device prices identically,
            # so the ascending scan commits device 0 (the tie rule)
            evals += ndev
            st = commit(st, pos, i, 0, st.stage_flip_pos(i, 0))
            continue
        if use_batch:
            fin = _peek_batch(st, da, i)
            peeks = None
            flips = slacks = None
        else:
            # one fused neighborhood walk prices every lane: all-device
            # peeks plus each lane's earliest flip position and vanish
            # slack (replaces d peeks + d per-lane flip scans)
            peeks, flips, slacks = st.price_lanes(i, ndev)
        best_j, best_t = 0, math.inf
        best_tmp: GraphSimState | None = None
        best_fp: int | None = None
        for j in range(ndev):
            if banned is not None and j in banned:
                continue   # departed device: the solver cannot place here
            evals += 1
            if use_batch:
                fp, _, _, slack = st._stage_flip_info(i, j)
            else:
                fp, slack = flips[j], slacks[j]
            if fp is None:
                t = float(fin[j]) if use_batch else peeks[j]
                tmp = None
            else:
                # the stale peek minus the vanishing stages' reclaimable
                # link time LOWER-bounds the exact price (appears only
                # insert occupancy; a vanish pulls events earlier by at
                # most the span it returns to the link — the clocks are
                # (max, +) so perturbations never amplify): a lane whose
                # bound already loses provably cannot win, and skipping
                # it leaves the selection exactly the all-lanes argmin
                peek = float(fin[j]) if use_batch else peeks[j]
                if peek - slack >= best_t - _EPS:
                    continue
                tmp, t = _resim_place(st, chain, pos, i, j, fp)
            if t < best_t - _EPS:
                best_j, best_t, best_tmp, best_fp = j, t, tmp, fp
        st.assign[i] = best_j
        st.placed[i] = 1
        if best_tmp is not None:
            # adopt the winning lane's re-simulation as the new head —
            # it IS the committed state (advanced through pos), so the
            # old rewind-and-re-advance second pass is gone
            chain.invalidate_above(best_fp // _SNAP_EVERY)
            st = best_tmp
        else:
            chain.advance_snapped(st, pos + 1)
    return st, evals, chain


def _prune_movable(ctx: GraphSimContext, st: GraphSimState,
                   movable: Sequence[int]) -> list[int]:
    """The pruned candidate set (DESIGN.md §14): movable tasks on or
    adjacent to the data-critical chain — walked backwards from the
    makespan task through each task's latest-finishing placed producer —
    plus the ``_PRUNE_TAIL`` latest-finishing movable tasks (the
    neighborhood of whatever straggled).  Moves of other tasks rarely
    shift the makespan; the descent only falls back to the full sweep
    when this set goes dry and budget remains."""
    finish = st.finish
    placed = st.placed
    keep: set[int] = set()
    c = max(range(ctx.n), key=lambda i: finish[i])
    while c not in keep:
        keep.add(c)
        best_u, best_f = c, -1.0
        for u in ctx.parents[c]:
            if placed[u] and finish[u] > best_f:
                best_u, best_f = u, finish[u]
        c = best_u
    for c in list(keep):
        keep.update(ctx.parents[c])
        keep.update(ctx.children[c])
    keep.update(sorted(movable, key=lambda i: finish[i],
                       reverse=True)[:_PRUNE_TAIL])
    # tail-first: later order positions first — their candidate walks
    # re-simulate the shortest suffixes (cheapest evals), they neighbor
    # the straggler (likeliest improvements), and each early accept
    # tightens the incumbent bound for the longer walks that follow.
    # Matters because a capped budget usually binds mid-sweep.
    return sorted((i for i in movable if i in keep),
                  key=ctx.pos_of.__getitem__, reverse=True)


def _descend_assign(ctx: GraphSimContext, assign: Sequence[int], *,
                    max_evals: int = 2000,
                    free: Sequence[int] | None = None,
                    prune: bool = True,
                    init: tuple[GraphSimState, _SnapChain] | None = None,
                    objective: Objective | None = None,
                    banned: frozenset[int] | None = None
                    ) -> tuple[list[int], int, float, list[float]]:
    """Reassignment descent on the exact graph makespan — ``_descend``'s
    pairwise-transfer loop in discrete per-task coordinates: move one task
    to another device, keep any strict improvement, repeat to a local
    optimum.  ``free`` restricts the moves to the given task indices
    (partial solves pin the frozen tasks).

    Each candidate move re-prices only the suffix of the priority order
    from the moved task's position (or from the earliest producer whose
    host-stage decision the move flips, if earlier), resumed from the
    nearest ``GraphSimState`` snapshot — positions before it are provably
    unaffected, so the makespans are exactly the from-scratch values.
    Returns ``(assign, evals, makespan, finish)`` — the local optimum's
    makespan and per-task finish times come from the last accepted head,
    so callers need no re-pricing replay.

    ``init`` hands over an already-advanced ``(state, chain)`` whose
    assignment equals ``assign`` — the EFT placement's final head — so the
    seed-pricing advance (a full suffix walk plus state construction) is
    skipped; its makespan was already computed by the placement."""
    movable = list(free) if free is not None else list(range(ctx.n))
    end = len(ctx.order)
    ndev = len(ctx.devices)
    if init is not None:
        st, chain = init
    else:
        st = GraphSimState(ctx, assign)
        # descent never rewinds below the earliest movable task or simulated
        # parent of one — skip snapshots below that floor (a partial
        # re-solve freezes most of the order; this keeps its setup cost at
        # O(free))
        floor = end
        for i in movable:
            floor = min(floor, ctx.pos_of[i])
            for u in ctx.parents[i]:
                if u not in ctx.ext:
                    p = ctx.pos_of.get(u)
                    if p is not None:
                        floor = min(floor, p)
        chain = _SnapChain(floor // _SNAP_EVERY)
        if chain.min_key == 0:
            chain.snaps[0] = st.snap_clone()
        chain.advance_snapped(st, end)
    # energy-weighted objective (DESIGN.md §16): candidates are accepted on
    # score = makespan + lam * energy.  The energy terms of a candidate
    # assignment are known BEFORE simulation (busy time is the sum of the
    # per-(device, task) compute table over the assignment), so the engine's
    # branch-and-bound stays exact: a candidate is prunable once its
    # makespan alone pushes the (linear, clamp-free lower bound of the)
    # score past the incumbent.  lam == 0 keeps the historical makespan
    # path byte-identical.
    lam = (objective.energy_weight
           if objective is not None and not objective.is_makespan else 0.0)
    if lam > 0.0:
        devs = ctx.devices
        iw = [d.idle_watts for d in devs]
        jpo = [d.joules_per_op for d in devs]
        opsv = [float(t.ops) for t in ctx.tasks]
        comp = ctx.comp
        si = sum(iw)
        busy, dyn = _graph_energy_parts(ctx, st.assign)
        wb = sum(w * b for w, b in zip(iw, busy))
        ms0 = max(st.finish)
        idle0 = sum(w * (ms0 - b) for w, b in zip(iw, busy)
                    if ms0 > b and w > 0.0)
        best = ms0 + lam * (dyn + idle0)
    else:
        best = max(st.finish)
    evals = 1
    # candidate-move pruning: sweep the critical-path neighborhood first,
    # falling back to the full sweep only when the pruned sweep goes dry
    # with budget remaining (and re-pruning when the full sweep improves)
    # (energy mode sweeps everything: a move off the critical path can
    # still cut joules)
    do_prune = prune and lam == 0.0 and ndev > 1 \
        and len(movable) >= _PRUNE_MIN_MOVABLE
    cands = _prune_movable(ctx, st, movable) if do_prune else movable
    pruned_now = do_prune
    nbanned = len(banned) if banned else 0
    use_batch = ndev - 1 - nbanned >= _BATCH_MIN_LANES and lam == 0.0
    # the budget binds mid-sweep, not only between sweeps: a single sweep
    # is len(free)·(d-1) candidate moves, which at 10^3+ nodes dwarfs any
    # reasonable budget — checking only in the while-condition made
    # ``max_evals`` a dead letter exactly where it matters (the capped
    # re-solve on a straggler's worker thread, DESIGN.md §11/§12)
    while evals < max_evals:
        improved = False
        for i in cands:
            if evals >= max_evals:
                break
            pi = ctx.pos_of[i]
            old = st.assign[i]
            if use_batch and max_evals - evals >= _BATCH_MIN_LANES:
                # batched move pricing: every alternative device of task i
                # in one GraphSimBatch sharing a single snapshot resume
                cand_devs = [j for j in range(ndev) if j != old
                             and (banned is None or j not in banned)]
                if not cand_devs:
                    continue
                p0 = pi
                for j in cand_devs:
                    fp = st.stage_flip_pos(i, j)
                    if fp is not None and fp < p0:
                        p0 = fp
                m = p0 // _SNAP_EVERY
                base = chain.state_at(m, st.assign, st.placed)
                batch = GraphSimBatch(base, i, cand_devs)
                batch.run(end, bound=best - _EPS)
                evals += len(cand_devs)
                ms = batch.makespans()
                l = int(ms.argmin())
                t = float(ms[l])
                if t < best - _EPS:
                    st.assign[i] = cand_devs[l]
                    new_st = batch.extract(l)
                    new_st.assign = st.assign
                    new_st.placed = st.placed
                    chain.invalidate_above(m)
                    st = new_st
                    best, improved = t, True
                continue
            for j in range(ndev):
                if evals >= max_evals:
                    break
                if j == old or (banned is not None and j in banned):
                    continue
                fp = st.stage_flip_pos(i, j)
                p0 = pi if fp is None or fp > pi else fp
                m = p0 // _SNAP_EVERY
                st.assign[i] = j
                tmp = chain.state_at(m, st.assign, st.placed)
                # bound-aware early exit: every simulated finish lower-
                # bounds the candidate's makespan, so the walk aborts the
                # moment one exceeds the incumbent; a completed walk is
                # byte-identical to an unbounded one, so accepted heads
                # (and the unpruned trajectory) are unchanged
                if lam > 0.0:
                    # candidate energy constants, pre-simulation: the
                    # makespan cap where even zero idle clamping cannot
                    # bring the score under the incumbent
                    dwb = iw[j] * comp[j][i] - iw[old] * comp[old][i]
                    ddyn = (jpo[j] - jpo[old]) * opsv[i]
                    cap = (best - lam * (dyn + ddyn - wb - dwb)) \
                        / (1.0 + lam * si)
                    done = tmp.advance(end, bound=cap - _EPS)
                else:
                    done = tmp.advance(end, bound=best - _EPS)
                evals += 1
                if lam > 0.0:
                    if done:
                        ms = max(tmp.finish)
                        busy[old] -= comp[old][i]
                        busy[j] += comp[j][i]
                        idle = sum(w * (ms - b)
                                   for w, b in zip(iw, busy)
                                   if ms > b and w > 0.0)
                        busy[old] += comp[old][i]
                        busy[j] -= comp[j][i]
                        t = ms + lam * (dyn + ddyn + idle)
                    else:
                        t = math.inf
                else:
                    t = max(tmp.finish) if done else math.inf
                if done and t < best - _EPS:
                    # adopt: the candidate walk already IS the new head
                    chain.invalidate_above(m)
                    st = tmp
                    best, improved = t, True
                    if lam > 0.0:
                        busy[old] -= comp[old][i]
                        busy[j] += comp[j][i]
                        wb += dwb
                        dyn += ddyn
                    old = j
                else:
                    st.assign[i] = old
        if improved:
            if do_prune and not pruned_now:
                cands = _prune_movable(ctx, st, movable)  # re-center
                pruned_now = True
        else:
            if pruned_now and evals < max_evals:
                # pruned sweep dry: one full sweep, same tail-first order
                cands = sorted(movable, key=ctx.pos_of.__getitem__,
                               reverse=True)
                pruned_now = False
            else:
                break
    return st.assign, evals, best, st.finish


class SolveContextCache:
    """Single-entry cache of (priority order, simulation context) for
    repeated re-solves of ONE task graph (DESIGN.md §14).

    The straggler-rescue path re-plans the same DAG every few milliseconds;
    the upward-rank order and the context's per-(device, task) duration
    tables depend only on (devices, tasks, edges, topology), while
    everything a re-plan changes — carried clocks, the frozen ``ext`` set,
    pins, seeds — is re-keyed per call via ``GraphSimContext.rebind`` in
    O(n).  The owner must dedicate one instance per graph (per
    ``StreamJob`` in the runtime); the entry is verified against
    (devices tuple, priority, topology spec), which covers model re-fits:
    a re-fit builds new frozen ``DeviceProfile``s, misses, and forces a
    rebuild against the fresh cost tables."""

    __slots__ = ("_entry",)

    def __init__(self):
        self._entry: tuple | None = None

    def lookup(self, key) -> tuple[list[int], GraphSimContext] | None:
        e = self._entry
        if e is not None and e[0] == key:
            return e[1], e[2]
        return None

    def store(self, key, order: list[int], ctx: GraphSimContext) -> None:
        self._entry = (key, order, ctx)


def solve_list_schedule(devices: Sequence[DeviceProfile],
                        tasks: Sequence[TaskSpec],
                        edges: Sequence[tuple[int, int]], *,
                        bus: str | BusTopology = "serialized",
                        priority: str = "rank",
                        refine: bool = True,
                        exhaustive_limit: int = 1024,
                        pinned: Mapping[int, int] | None = None,
                        ext: Mapping[int, tuple[float, float]] | None = None,
                        clocks: ClockState = ZERO_CLOCKS,
                        seed_assign: Sequence[int] | None = None,
                        max_evals: int = 2000,
                        prune: bool = True,
                        cache: SolveContextCache | None = None,
                        objective: Objective | None = None,
                        banned: Sequence[int] | frozenset[int] | None = None
                        ) -> GraphScheduleResult:
    """Minimize a task graph's makespan by list scheduling on the engine.

    HEFT shape: tasks are placed in decreasing upward-rank order
    (``priority="rank"``); each is assigned the device giving it the
    earliest engine finish time over the partial schedule — so link
    queueing, host staging of cross-device edges, and carried clocks are
    priced exactly as the simulator reports and the executor replays.
    ``priority="topo"`` is the naive baseline: plain topological order
    with myopic device selection (each task alone on an empty timeline —
    ignores contention and edge locality), the benchmark's strawman.

    Refinement: when the free assignment space is small
    (``len(devices)**len(free) <= exhaustive_limit``) the solver
    enumerates every assignment under the same priority order and returns
    the exact optimum; otherwise reassignment descent polishes the HEFT
    placement to a local optimum on the same engine makespan.

    Partial solve (mid-graph re-planning, DESIGN.md §11): ``pinned`` maps
    task index -> device index for tasks whose assignment is *frozen*
    (completed or already running); only the remaining tasks are placed and
    refined.  ``ext`` prices the frozen tasks externally (their measured
    ``(compute_end, avail)`` — see ``build_graph_timeline``), ``clocks``
    carries the measured link/device clocks the frontier must queue behind,
    and ``seed_assign`` seeds the refinement from the currently-executing
    plan so the re-solve starts no worse than the lock-in it replaces.
    When a seed is given the degenerate all-one-device sweeps are skipped —
    the seed already provides the quality floor, and a partial solve runs
    inside a live splice where solver latency stalls the straggler's worker
    (``max_evals`` caps each descent for the same reason).

    ``objective``: pure makespan (None / weight 0) keeps the selection
    bit-identical to the historical solver and just reports ``energy_j``;
    an energy-weighted objective scores candidates by
    ``makespan + weight * joules`` (DESIGN.md §16).  ``banned`` names
    device *indices* the solver must not place free tasks on — the elastic
    membership path (device loss) re-solves with the departed device
    banned so spec device tuples and clock names stay aligned while the
    shrunken cluster is genuinely enforced.
    """
    topo = BusTopology.from_spec(bus, devices)
    spec = bus.spec if isinstance(bus, BusTopology) else topo.spec
    n = len(tasks)
    if n == 0:
        z = [0.0] * len(devices)
        return GraphScheduleResult(z, 0.0, z, spec)
    banned = frozenset(banned) if banned else None
    pinned = dict(pinned) if pinned else {}
    free = [i for i in range(n) if i not in pinned]
    ckey = (tuple(devices), priority, spec) if cache is not None else None
    hit = cache.lookup(ckey) if cache is not None else None
    if hit is not None:
        order, tmpl = hit
        ctx = tmpl.rebind(clocks, ext)
    else:
        if priority == "rank":
            order = _rank_order(devices, tasks, edges)
        elif priority == "topo":
            order = _graph_topo_order(n, edges)
        else:
            raise ValueError(f"unknown priority {priority!r} "
                             "(expected 'rank' or 'topo')")
        ctx = GraphSimContext(devices, tasks, edges, topo, order, clocks,
                              ext)
        if cache is not None:
            cache.store(ckey, order, ctx)

    def finish(a) -> list[float]:
        # the engine replay on the (possibly cached) context — the same
        # single simulation loop ``graph_finish_times`` wraps, minus its
        # per-call context construction
        stf = GraphSimState(ctx, list(a))
        stf.advance(len(order))
        return stf.finish

    allowed = [j for j in range(len(devices))
               if banned is None or j not in banned]
    assign = [-1] * n
    for i, j in pinned.items():
        assign[i] = j
    evals = 0
    # the final head state's finish times, when a path produces them —
    # saves the closing ``finish(assign)`` replay (an extra full state
    # construction + suffix walk per solve on the re-plan hot path)
    task_fin: list[float] | None = None
    eft_init: tuple[GraphSimState, _SnapChain] | None = None
    if priority == "topo":
        solo = [-1] * n   # scratch assignment, reused across candidates
        for i in order:
            if i in pinned:
                continue
            best_j, best_t = allowed[0], math.inf
            for j in allowed:
                # myopic: the task alone, an empty timeline
                solo[i] = j
                t = graph_finish_times(devices, tasks, edges, solo,
                                       topology=topo, order=[i])[i]
                evals += 1
                if t < best_t - _EPS:
                    best_j, best_t = j, t
            solo[i] = -1
            assign[i] = best_j
    else:
        st, e, eft_chain = _eft_place(ctx, assign, pinned, banned)
        assign = st.assign
        evals += e
        task_fin = st.finish
        eft_init = (st, eft_chain)

    def makespan(a) -> float:
        return max(finish(a))

    energy_mode = objective is not None and not objective.is_makespan

    def score_of(a, fin) -> float:
        ms = max(fin)
        if not energy_mode:
            return ms
        return objective.score(ms, graph_energy(ctx, a, ms))

    if refine and free:
        # the exhaustive branch honours max_evals too: a latency-capped
        # partial solve (mid-graph splice) must not sneak up to
        # exhaustive_limit full-graph simulations through a small free set
        if len(allowed) ** len(free) <= min(exhaustive_limit, max_evals):
            fin0 = finish(assign)
            best_a, best_t = list(assign), score_of(assign, fin0)
            evals += 1
            for combo in itertools.product(allowed, repeat=len(free)):
                cand = list(assign)
                for i, j in zip(free, combo):
                    cand[i] = j
                t = score_of(cand, finish(cand))
                evals += 1
                if t < best_t - _EPS:
                    best_a, best_t = list(cand), t
            assign = best_a
            task_fin = None   # enumerate picked a new assignment; replay
        else:
            # Descend from the EFT placement AND from every degenerate
            # all-one-device assignment (the §3.4.3 caveat, in DAG form):
            # EFT's greedy early finishes can strand the schedule in a
            # local optimum *worse* than the best single device, and
            # single-task moves cannot escape it (moving one task of a
            # chain adds edge copies before its neighbours follow).
            # Seeding from the degenerate points both restores the
            # never-worse-than-one-device floor and lets the descent peel
            # whole chains off the fastest device one improvement at a
            # time.  Partial solves additionally seed from the plan being
            # replaced (``seed_assign``), so a re-plan is never worse than
            # staying locked in — under the re-fitted models.
            seeds = [list(assign)]
            best_a, best_t = None, math.inf
            best_fin: list[float] | None = None
            if seed_assign is not None:
                sa = list(seed_assign)
                if sa != seeds[0]:   # identical seed: don't split the pool
                    seeds.append(sa)
                # the straggler-rescue seed: every free task on the fastest
                # (re-fitted) device — the shape the re-plan usually wants
                # when one device just slowed down, and one the capped
                # descent cannot reliably reach from EFT local optima
                fastest = max(allowed,
                              key=lambda j: devices[j].effective_speed)
                rescue = list(assign)
                for i in free:
                    rescue[i] = fastest
                if rescue not in seeds:
                    seeds.append(rescue)
                # a partial solve runs inside a live splice: the eval
                # budget is one shared pool the seeds draw down in turn —
                # the old per-seed split (``max_evals // len(seeds)`` with
                # a floor of 40) let the *sum* overshoot the cap whenever
                # it was small (3 seeds x 40 at max_evals=60 spent double
                # the latency the splice asked for).  Every seed still
                # gets >= 1 eval — pricing the seed assignment itself —
                # preserving the never-worse-than-any-seed floor.
                remaining = max_evals
                for k, seed in enumerate(seeds):
                    share = max(1, remaining // (len(seeds) - k))
                    cand, e, t, fin = _descend_assign(
                        ctx, seed, free=free, max_evals=share, prune=prune,
                        init=eft_init if k == 0 else None,
                        objective=objective, banned=banned)
                    remaining = max(0, remaining - e)
                    evals += e
                    if best_a is None or t < best_t - _EPS:
                        best_a, best_t, best_fin = cand, t, fin
            else:
                for j in allowed:
                    one = list(assign)
                    for i in free:
                        one[i] = j
                    seeds.append(one)
                for k, seed in enumerate(seeds):
                    cand, e, t, fin = _descend_assign(
                        ctx, seed, free=free, max_evals=max_evals,
                        prune=prune, init=eft_init if k == 0 else None,
                        objective=objective, banned=banned)
                    evals += e
                    if best_a is None or t < best_t - _EPS:
                        best_a, best_t, best_fin = cand, t, fin
            assign = best_a
            task_fin = best_fin

    task_finish = task_fin if task_fin is not None else finish(assign)
    ops = [0.0] * len(devices)
    dev_finish = [0.0] * len(devices)
    for i, t in enumerate(tasks):
        if assign[i] < 0:
            continue
        ops[assign[i]] += float(t.ops)
        dev_finish[assign[i]] = max(dev_finish[assign[i]], task_finish[i])
    ms = max(task_finish)
    return GraphScheduleResult(ops=ops, makespan=ms,
                               finish_times=dev_finish, bus=spec,
                               iterations=evals, assign=list(assign),
                               order=list(order),
                               task_finish=list(task_finish),
                               energy_j=(graph_energy(ctx, assign, ms)
                                         if objective is not None else None))

# ---------------------------------------------------------------------------
# Template-tiled hierarchical solves (DESIGN.md §15)
# ---------------------------------------------------------------------------


class TemplatePlanCache:
    """Process-wide LRU of representative template placements.

    Keyed by ``(template signature, devices, topology spec, refine)``.
    The signature (``TemplatePartition.signatures[t]``) *is* the
    representative solve's entire input — per-slot costs, internal edges
    in slot coordinates, boundary arity — so a hit is exact no matter
    which graph produced it: structurally-equal stacks of different
    depths, different jobs, and different tenants share one entry (the
    module-level default instance is what ``solve_hierarchical`` uses
    when no cache is passed).  Thread-safe: the multi-tenant runtime
    plans from per-job worker threads."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key) -> tuple[int, ...] | None:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return e

    def put(self, key, assign: Sequence[int]) -> None:
        with self._lock:
            self._entries[key] = tuple(assign)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0


#: the default cross-job, cross-tenant share point
SHARED_TEMPLATE_CACHE = TemplatePlanCache()

_POLISH_EVALS = 64        # seam-descent budget (see solve_hierarchical)
_POLISH_MAX_NODES = 4096  # snapshot-chain clones are O(n) each; above this
                          # the descent setup alone would eat the latency win


def solve_hierarchical(devices: Sequence[DeviceProfile],
                       tasks: Sequence[TaskSpec],
                       edges: Sequence[tuple[int, int]], *,
                       partition,
                       bus: str | BusTopology = "serialized",
                       refine: bool = True,
                       template_cache: TemplatePlanCache | None = None,
                       rep_max_evals: int = 800,
                       polish_evals: int = _POLISH_EVALS,
                       polish_max_nodes: int = _POLISH_MAX_NODES,
                       objective: Objective | None = None
                       ) -> GraphScheduleResult:
    """Template-tiled list scheduling for repetitive DAGs (DESIGN.md §15).

    ``partition`` is a ``TemplatePartition`` (``detect_templates`` /
    ``TaskGraph.template_partition``).  Instead of EFT-placing all ``n``
    tasks — superlinear in ``n`` through the per-candidate engine walks —
    the solver (1) list-schedules ONE representative instance per
    template (boundary in-bytes folded into the entry slots; memoized in
    the shared ``TemplatePlanCache``), (2) stitches that placement across
    every instance by slot, and (3) prices the stitched whole-graph
    assignment with a single exact engine simulation — the same
    single-loop ground truth every other path uses, so the reported
    makespan/finish times are byte-identical to a from-scratch simulation
    of the same assignment.

    Quality contract (the §14 shape): the result is never worse than the
    best all-one-device assignment — every degenerate placement is priced
    with a bound-aware early-exit walk and adopted if it wins — and on
    graphs small enough for the snapshot machinery (``polish_max_nodes``)
    PR-8's pruned descent additionally polishes the *seam* tasks (those
    with cross-instance edges), the only places where tiling can disagree
    with flat placement.  Cost: near-linear in instance count — templates
    are solved once each, stitching is O(n), and the engine walks are the
    O(n log n) simulation itself."""
    topo = BusTopology.from_spec(bus, devices)
    spec = bus.spec if isinstance(bus, BusTopology) else topo.spec
    n = len(tasks)
    if n == 0:
        z = [0.0] * len(devices)
        return GraphScheduleResult(z, 0.0, z, spec)
    cache = template_cache if template_cache is not None \
        else SHARED_TEMPLATE_CACHE
    dev_key = tuple(devices)
    evals = 0
    energy_mode = objective is not None and not objective.is_makespan

    # 1. one representative solve per template, cached by signature.  An
    # energy-weighted objective picks different representative placements,
    # so it gets its own cache entries; pure makespan keeps the historical
    # 4-tuple key (and therefore its warm entries).
    placements: list[tuple[int, ...]] = []
    for sig in partition.signatures:
        key = (sig, dev_key, spec, bool(refine))
        if energy_mode:
            key = key + (objective.energy_weight,)
        hit = cache.get(key)
        if hit is None:
            costs, internal, inb, _outb = sig
            extra_in: dict[int, float] = {}
            for slot, b in inb:
                extra_in[slot] = extra_in.get(slot, 0.0) + float(b)
            rep = [TaskSpec(f"t{k}", float(ops_k),
                            float(in_b) + extra_in.get(k, 0.0),
                            float(out_b))
                   for k, (ops_k, in_b, out_b) in enumerate(costs)]
            r = solve_list_schedule(devices, rep, internal, bus=topo,
                                    refine=refine,
                                    max_evals=rep_max_evals,
                                    objective=objective)
            evals += r.iterations
            hit = tuple(r.assign)
            cache.put(key, hit)
        placements.append(hit)

    # 2. stitch the template placements across every instance by slot
    assign = [0] * n
    for inst, t in zip(partition.instances, partition.template_of):
        pl = placements[t]
        for k, i in enumerate(inst):
            assign[i] = pl[k]

    # 3. exact pricing: one engine simulation of the stitched assignment
    order = _graph_topo_order(n, edges)
    ctx = GraphSimContext(devices, tasks, edges, topo, order)
    st = GraphSimState(ctx, assign)
    st.advance(len(order))
    evals += 1
    best_ms = max(st.finish)
    # ``best`` is the objective score (== makespan in pure-makespan mode).
    # Score >= makespan always (energy >= 0), so the makespan lower bounds
    # and bound-aware engine walks below stay valid prunes under a score.
    best = (objective.score(best_ms, graph_energy(ctx, assign, best_ms))
            if energy_mode else best_ms)
    task_fin = st.finish

    # 4. the all-one-device floor.  An all-on-j schedule serializes every
    # task's compute on j, so Σ compute is an exact lower bound on its
    # makespan — O(1) under a linear model.  Only devices that could
    # actually beat the stitched placement pay for the full bound-aware
    # engine walk; the rest are pruned analytically (at 10^4+ nodes the
    # three losing walks would otherwise dominate the whole solve).
    total_ops = sum(float(tk.ops) for tk in tasks)
    for j, dev in enumerate(devices):
        tm = dev.compute
        if isinstance(tm, LinearTimeModel):
            lower = tm.a * total_ops + tm.b * n
        else:
            lower = sum(tm(tk.ops) for tk in tasks)
        if lower >= best - _EPS:
            continue
        onej = [j] * n
        if onej == assign:
            continue
        tmp = GraphSimState(ctx, onej)
        done = tmp.advance(len(order), bound=best - _EPS)
        evals += 1
        if done:
            ms1 = max(tmp.finish)
            t1 = (objective.score(ms1, graph_energy(ctx, onej, ms1))
                  if energy_mode else ms1)
            if t1 < best - _EPS:
                assign, best, task_fin = onej, t1, tmp.finish
                best_ms = ms1

    # 5. seam polish: pruned descent over cross-instance tasks only
    if refine and polish_evals > 0 and n <= polish_max_nodes:
        inst_of = [-1] * n
        for a, inst in enumerate(partition.instances):
            for i in inst:
                inst_of[i] = a
        seams = sorted({x for u, v in edges
                        if inst_of[u] != inst_of[v] for x in (u, v)})
        if seams:
            cand, e, t2, fin = _descend_assign(ctx, list(assign),
                                               free=seams,
                                               max_evals=polish_evals,
                                               prune=True,
                                               objective=objective)
            evals += e
            if t2 < best - _EPS:
                assign, best, task_fin = cand, t2, fin
                best_ms = max(fin)

    ops = [0.0] * len(devices)
    dev_finish = [0.0] * len(devices)
    for i, tk in enumerate(tasks):
        ops[assign[i]] += float(tk.ops)
        dev_finish[assign[i]] = max(dev_finish[assign[i]], task_fin[i])
    return GraphScheduleResult(ops=ops, makespan=best_ms,
                               finish_times=dev_finish, bus=spec,
                               iterations=evals, assign=list(assign),
                               order=list(order),
                               task_finish=list(task_fin),
                               energy_j=(graph_energy(ctx, assign, best_ms)
                                         if objective is not None else None))
