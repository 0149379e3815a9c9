"""Task-graph workloads — POAS for precedence-constrained DAGs (DESIGN.md §10).

Every shipped domain so far assumes one *divisible* workload whose ops are
split by share; the paper's claim that POAS "transforms any application"
needs applications with internal structure.  This module adds that workload
class end to end:

* ``TaskGraph`` / ``TaskNode`` — a validated DAG of tasks (per-task op
  counts, external input bytes, output bytes, precedence edges) that
  implements the ``Workload`` protocol (``total_ops`` = sum over nodes)
  with a structural ``cost_signature``, so the ``PlanCache`` works
  unchanged;
* ``TaskGraphDomain`` (registered as ``"task-graph"``) — the four POAS
  phases for DAGs: Predict reuses the per-device models (re-fitted by the
  ``DynamicScheduler`` under per-task observations), Optimize is the
  HEFT-style ``solve_list_schedule`` priced on the unified timeline engine,
  Adapt maps the assignment back to per-device task lists (``GraphPlan``),
  Schedule emits a ``GraphTimelineSpec``-backed timeline the streaming
  runtime rebase/executes like any other plan;
* ``transformer_block`` — the case-study builder: a transformer block
  (grouped QKV/attention heads → projection → residual → grouped MLP)
  as a schedulable DAG across CPU/GPU/XPU, instead of one divisible matmul;
* ``verify_graph_dependencies`` — the timeline invariant: no task's
  compute starts before every upstream task's output has landed.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Hashable, Iterable, Sequence

from .bus import (BusTopology, GraphTimelineSpec, TaskSpec, Timeline,
                  _graph_topo_order)
from .device_model import DeviceProfile, priority_order
from .domain import register_domain
from .optimize import (GraphScheduleResult, OptimizeResult,
                       solve_hierarchical, solve_list_schedule)
from .schedule import DynamicScheduler, Schedule


# ---------------------------------------------------------------------------
# The workload
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TaskNode:
    """One task: ``ops`` multiply-accumulates, ``in_bytes`` of external
    (host-resident) input — weights, graph inputs — and ``out_bytes`` of
    produced data (what travels on out-edges / returns to host at sinks)."""

    name: str
    ops: float
    in_bytes: float = 0.0
    out_bytes: float = 0.0


@dataclasses.dataclass(frozen=True)
class TaskGraph:
    """A validated precedence DAG implementing the ``Workload`` protocol.

    ``edges`` are ``(producer_name, consumer_name)`` pairs.  Validation
    (unique names, known endpoints, no self-edges, acyclicity) runs at
    construction; ``topo_order`` / ``critical_path`` / ``cost_signature``
    are the queries the solver, cache, and benchmarks need.
    """

    nodes: tuple[TaskNode, ...]
    edges: tuple[tuple[str, str], ...] = ()
    #: optional structural metadata from builders: a partition of (some of)
    #: the task names into repeated blocks, in construction order — the
    #: template detector's free fast path (``detect_templates``).  Carries
    #: no cost information, so it is excluded from ``cost_signature``.
    blocks: tuple[tuple[str, ...], ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "_memo", {})
        names = [t.name for t in self.nodes]
        if len(set(names)) != len(names):
            dup = sorted(n for n, c in Counter(names).items() if c > 1)
            raise ValueError(f"duplicate task names: {dup}")
        index = {n: i for i, n in enumerate(names)}
        parents: dict[str, list[str]] = {n: [] for n in names}
        children: dict[str, list[str]] = {n: [] for n in names}
        for u, v in self.edges:
            for end in (u, v):
                if end not in index:
                    raise ValueError(f"edge ({u!r}, {v!r}) references "
                                     f"unknown task {end!r}")
            if u == v:
                raise ValueError(f"self-edge on task {u!r}")
            parents[v].append(u)
            children[u].append(v)
        object.__setattr__(self, "_index", index)
        object.__setattr__(self, "_parents",
                           {n: tuple(ps) for n, ps in parents.items()})
        object.__setattr__(self, "_children",
                           {n: tuple(cs) for n, cs in children.items()})
        seen_blk: set[str] = set()
        for blk in self.blocks:
            for bn in blk:
                if bn not in index:
                    raise ValueError(f"block references unknown task {bn!r}")
                if bn in seen_blk:
                    raise ValueError(f"task {bn!r} appears in two blocks")
                seen_blk.add(bn)
        _graph_topo_order(len(self.nodes), self.edge_indices())  # acyclic?

    # -- queries -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.nodes)

    def index(self, name: str) -> int:
        return self._index[name]

    def node(self, name: str) -> TaskNode:
        return self.nodes[self._index[name]]

    def edge_indices(self) -> tuple[tuple[int, int], ...]:
        memo = self._memo
        out = memo.get("edge_indices")
        if out is None:
            out = tuple((self._index[u], self._index[v])
                        for u, v in self.edges)
            memo["edge_indices"] = out
        return out

    def parents(self, name: str) -> tuple[str, ...]:
        return self._parents[name]

    def children(self, name: str) -> tuple[str, ...]:
        return self._children[name]

    def total_ops(self) -> float:
        return float(sum(t.ops for t in self.nodes))

    def topo_order(self) -> list[int]:
        memo = self._memo
        out = memo.get("topo_order")
        if out is None:
            out = _graph_topo_order(len(self.nodes), self.edge_indices())
            memo["topo_order"] = out
        return list(out)

    def critical_path(self) -> tuple[float, list[str]]:
        """Ops-weighted longest path: the lower bound no schedule can beat
        regardless of device count (returns total ops along it and the
        task names)."""
        n = len(self.nodes)
        edges = self.edge_indices()
        children: list[list[int]] = [[] for _ in range(n)]
        for u, v in edges:
            children[u].append(v)
        length = [0.0] * n
        nxt: list[int | None] = [None] * n
        for i in reversed(self.topo_order()):
            best, best_c = 0.0, None
            for c in children[i]:
                if length[c] > best:
                    best, best_c = length[c], c
            length[i] = self.nodes[i].ops + best
            nxt[i] = best_c
        start = max(range(n), key=lambda i: length[i])
        path, i = [], start
        while i is not None:
            path.append(self.nodes[i].name)
            i = nxt[i]
        return length[start], path

    def task_specs(self) -> tuple[TaskSpec, ...]:
        memo = self._memo
        out = memo.get("task_specs")
        if out is None:
            out = tuple(TaskSpec(t.name, float(t.ops), float(t.in_bytes),
                                 float(t.out_bytes)) for t in self.nodes)
            memo["task_specs"] = out
        return out

    def cost_signature(self) -> Hashable:
        """Everything the solved plan depends on: per-task numbers plus the
        edge structure (device models are keyed separately by the cache).
        Memoized — the graph is immutable and this tuple is rebuilt on every
        ``PlanCache`` probe, which at 10^4 nodes dominated cache hits."""
        memo = self._memo
        out = memo.get("cost_signature")
        if out is None:
            out = (tuple((t.name, t.ops, t.in_bytes, t.out_bytes)
                         for t in self.nodes), self.edges)
            memo["cost_signature"] = out
        return out

    def template_partition(self, *, min_repeats: int = 4
                           ) -> "TemplatePartition | None":
        """Memoized ``detect_templates`` (the graph is immutable, and the
        domain re-detects on every plan-cache miss)."""
        memo = self._memo
        key = ("template_partition", min_repeats)
        if key not in memo:
            memo[key] = detect_templates(self, min_repeats=min_repeats)
        return memo[key]

    def frontier_subgraph(self, started: Iterable[str]
                          ) -> tuple["TaskGraph",
                                     tuple[tuple[str, str], ...]]:
        """The not-yet-started successor frontier (mid-graph re-planning,
        DESIGN.md §11): the subgraph of tasks NOT in ``started``, plus the
        boundary edges (started producer → frontier consumer) that cross
        the freeze line.

        ``started`` must be *ancestor-closed* — a task cannot have started
        before its parents finished, so a started task with a not-started
        parent means the caller's progress snapshot is corrupt (raises).
        In the returned subgraph each boundary edge's payload is folded
        into the consumer's ``in_bytes`` (the frozen producer's output must
        be read back from the host once the frontier is re-placed); callers
        that re-solve the *full* graph with pinned assignments (the exact
        path — same-device boundary edges stay free) want the boundary list
        and the frontier names, not the folded bytes.
        """
        started_set = set(started)
        unknown = started_set - set(self._index)
        if unknown:
            raise ValueError(f"unknown started tasks: {sorted(unknown)}")
        for u, v in self.edges:
            if v in started_set and u not in started_set:
                raise ValueError(
                    f"started task {v!r} has a not-started parent {u!r}: "
                    "the started set is not ancestor-closed")
        frontier = [t for t in self.nodes if t.name not in started_set]
        boundary = tuple((u, v) for u, v in self.edges
                         if u in started_set and v not in started_set)
        extra_in: dict[str, float] = {}
        for u, v in boundary:
            extra_in[v] = extra_in.get(v, 0.0) + self.node(u).out_bytes
        nodes = tuple(dataclasses.replace(
            t, in_bytes=t.in_bytes + extra_in.get(t.name, 0.0))
            for t in frontier)
        edges = tuple((u, v) for u, v in self.edges
                      if u not in started_set and v not in started_set)
        return TaskGraph(nodes=nodes, edges=edges), boundary


# ---------------------------------------------------------------------------
# Template detection (DESIGN.md §15)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TemplatePartition:
    """A partition of a ``TaskGraph`` into repeated template instances.

    ``instances[a]`` lists instance *a*'s node indices in topological
    order (slot order); ``template_of[a]`` is its template id;
    ``signatures[t]`` is template *t*'s canonical signature — per-slot
    costs, internal edges in slot coordinates, and boundary arity
    (in-edges as ``(consumer_slot, producer_out_bytes)``, out-edges as
    ``(producer_slot, count)``).  Names are excluded, so structurally
    equal blocks match across layers, microbatches, graphs, and tenants;
    the signature is also everything ``solve_hierarchical`` needs to
    build and cache a representative sub-solve, so the template cache
    key *is* the solve input."""

    instances: tuple[tuple[int, ...], ...]
    template_of: tuple[int, ...]
    signatures: tuple[Hashable, ...]

    @property
    def n_templates(self) -> int:
        return len(self.signatures)

    def repeats(self) -> Counter:
        """Template id -> instance count."""
        return Counter(self.template_of)


def _generic_instances(n: int, children: Sequence[Sequence[int]],
                       topo: Sequence[int], nodes: Sequence[TaskNode]
                       ) -> list[list[int]]:
    """Fallback instance discovery for graphs without builder blocks.

    Per weakly-connected component (in topological order): cut after
    position ``p`` whenever at most one producer's edges cross into the
    suffix — computed with a difference array over producer spans
    ``[pos(u), last_child_pos(u))`` — giving *minimal* segments; then
    merge consecutive segments at the smallest period under which the
    segment-key sequence (costs + internal edge shape, boundary-blind)
    is fully periodic, so one instance spans one structural repeat
    rather than one articulation slice."""
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u in range(n):
        for v in children[u]:
            ru, rv = find(u), find(v)
            if ru != rv:
                parent[ru] = rv
    comps: dict[int, list[int]] = {}
    for i in topo:
        comps.setdefault(find(i), []).append(i)

    def seg_key(comp: list[int], cpos: dict[int, int], lo: int,
                hi: int) -> Hashable:
        seg = comp[lo:hi]
        costs = tuple((nodes[i].ops, nodes[i].in_bytes, nodes[i].out_bytes)
                      for i in seg)
        internal = sorted((cpos[i] - lo, cpos[c] - lo)
                          for i in seg for c in children[i]
                          if lo <= cpos[c] < hi)
        return costs, tuple(internal)

    instances: list[list[int]] = []
    for comp in comps.values():
        m = len(comp)
        cpos = {node: k for k, node in enumerate(comp)}
        diff = [0] * (m + 1)
        for node in comp:
            ch = children[node]
            if ch:
                diff[cpos[node]] += 1
                diff[max(cpos[c] for c in ch)] -= 1
        bounds = [0]
        run = 0
        for k in range(m):
            run += diff[k]
            if run <= 1:
                bounds.append(k + 1)
        segs = list(zip(bounds[:-1], bounds[1:]))
        keys = [seg_key(comp, cpos, lo, hi) for lo, hi in segs]
        msg = len(segs)
        merged = None
        for p in range(1, msg // 2 + 1):
            if all(keys[i] == keys[i + p] for i in range(msg - p)):
                merged = [comp[segs[i][0]:segs[min(i + p, msg) - 1][1]]
                          for i in range(0, msg, p)]
                break
        if merged is not None:
            instances.extend(merged)
        else:
            instances.extend(comp[lo:hi] for lo, hi in segs)
    return instances


def detect_templates(graph: TaskGraph, *, min_repeats: int = 4
                     ) -> TemplatePartition | None:
    """Partition ``graph`` into repeated template instances, or ``None``
    when the graph is not repetitive enough for tiling to pay off.

    Builder-emitted ``blocks`` are the free fast path (uncovered nodes
    become singleton instances); otherwise the generic detector cuts
    each weakly-connected component at single-crossing-producer points
    and merges the minimal segments at the smallest structural period.
    Instances are grouped into templates by canonical signature — node
    costs, internal edge shape, boundary arity — so blocks differing in
    any one node's costs or in how they are fed never merge.  Returns
    ``None`` unless the dominant template repeats ``min_repeats`` times
    AND template-covered instances span most of the graph (tiling a
    mostly-unique graph would just be per-fragment EFT)."""
    n = len(graph.nodes)
    if n == 0 or min_repeats < 2:
        return None
    edges = graph.edge_indices()
    topo = graph.topo_order()
    pos = [0] * n
    for p, i in enumerate(topo):
        pos[i] = p

    if graph.blocks:
        inst = [sorted((graph.index(b) for b in blk), key=pos.__getitem__)
                for blk in graph.blocks]
        covered = {i for s in inst for i in s}
        inst.extend([i] for i in topo if i not in covered)
    else:
        children: list[list[int]] = [[] for _ in range(n)]
        for u, v in edges:
            children[u].append(v)
        inst = _generic_instances(n, children, topo, graph.nodes)
    if not inst or n < 2.0 * len(inst):
        return None   # degenerate: near-singleton instances, nothing to tile

    inst_of = [-1] * n
    slot_of = [0] * n
    for a, s in enumerate(inst):
        for k, i in enumerate(s):
            inst_of[i] = a
            slot_of[i] = k
    internal: list[list[tuple[int, int]]] = [[] for _ in inst]
    inb: list[list[tuple[int, float]]] = [[] for _ in inst]
    outb: list[list[int]] = [[] for _ in inst]
    for u, v in edges:
        a, b = inst_of[u], inst_of[v]
        if a == b:
            internal[a].append((slot_of[u], slot_of[v]))
        else:
            outb[a].append(slot_of[u])
            inb[b].append((slot_of[v], float(graph.nodes[u].out_bytes)))

    sig_id: dict[Hashable, int] = {}
    signatures: list[Hashable] = []
    template_of: list[int] = []
    for a, s in enumerate(inst):
        costs = tuple((graph.nodes[i].ops, graph.nodes[i].in_bytes,
                       graph.nodes[i].out_bytes) for i in s)
        sig = (costs, tuple(sorted(internal[a])), tuple(sorted(inb[a])),
               tuple(sorted(Counter(outb[a]).items())))
        t = sig_id.get(sig)
        if t is None:
            t = len(signatures)
            sig_id[sig] = t
            signatures.append(sig)
        template_of.append(t)

    counts = Counter(template_of)
    if max(counts.values()) < min_repeats:
        return None
    covered_nodes = sum(len(s) for a, s in enumerate(inst)
                        if counts[template_of[a]] >= min_repeats)
    if 2 * covered_nodes < n:
        return None
    return TemplatePartition(instances=tuple(tuple(s) for s in inst),
                             template_of=tuple(template_of),
                             signatures=tuple(signatures))


# ---------------------------------------------------------------------------
# Adapt output: the assignment in domain coordinates
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphPlan:
    """Phase-3 output: which tasks each device runs, in planned order.

    ``assignments`` maps device name -> task names (planned execution
    order per device); ``assign``/``order`` are the solver coordinates the
    schedule phase rebuilds the timeline from.  Frozen because instances
    are shared across ``PlanCache`` hits.
    """

    assignments: tuple[tuple[str, tuple[str, ...]], ...]
    assign: tuple[int, ...]
    order: tuple[int, ...]

    def tasks_of(self, device: str) -> tuple[str, ...]:
        for name, tasks in self.assignments:
            if name == device:
                return tasks
        return ()


# ---------------------------------------------------------------------------
# The domain
# ---------------------------------------------------------------------------


@register_domain("task-graph")
class TaskGraphDomain:
    """DS-POAS for precedence-constrained task graphs."""

    name = "task-graph"

    def __init__(self, devices: Sequence[DeviceProfile], *,
                 bus: str | BusTopology = "serialized",
                 dynamic: bool = False, refine: bool = True,
                 hierarchical: bool | str = "auto",
                 min_repeats: int = 4):
        self._devices = list(devices)
        self.topology = BusTopology.from_spec(bus, self._devices)
        self.bus = self.topology.spec
        self.refine = refine
        self.hierarchical = hierarchical
        self.min_repeats = min_repeats
        self.dyn = DynamicScheduler(self._devices, bus=self.topology) \
            if dynamic else None

    def predict(self) -> Sequence[DeviceProfile]:
        return self.dyn.snapshot() if self.dyn is not None else self._devices

    def set_devices(self, devices: Sequence[DeviceProfile], *,
                    topology: "str | BusTopology | None" = None) -> None:
        """Elastic membership change-point (DESIGN.md §16): swap the
        planning device set, so the next admission solves on the new
        cluster.  ``topology`` replaces the bus when given; spec-string
        topologies are rebuilt for the new device list automatically,
        while a custom ``BusTopology`` is kept as-is (its attach rows are
        name-keyed, so rows for departed devices are simply unused —
        joiners need an explicit ``topology``).  Dynamic mode carries
        re-fitted models for surviving devices and invalidates hooked
        plan caches via the scheduler's re-fit listeners."""
        self._devices = list(devices)
        if topology is not None:
            self.topology = BusTopology.from_spec(topology, self._devices)
        elif self.topology.spec in ("serialized", "independent"):
            self.topology = BusTopology.from_spec(self.topology.spec,
                                                  self._devices)
        self.bus = self.topology.spec
        if self.dyn is not None:
            self.dyn.bus = self.topology
            self.dyn.set_devices(self._devices)

    def optimize(self, devices: Sequence[DeviceProfile],
                 w: TaskGraph) -> GraphScheduleResult:
        # the template-tiled path (DESIGN.md §15) kicks in automatically
        # when the detector finds enough repeated structure; flat list
        # scheduling stays the path for one-off / irregular graphs
        if self.hierarchical and isinstance(w, TaskGraph):
            part = w.template_partition(min_repeats=self.min_repeats)
            if part is not None:
                return solve_hierarchical(devices, w.task_specs(),
                                          w.edge_indices(), partition=part,
                                          bus=self.topology,
                                          refine=self.refine)
        return solve_list_schedule(devices, w.task_specs(),
                                   w.edge_indices(), bus=self.topology,
                                   refine=self.refine)

    def adapt(self, devices: Sequence[DeviceProfile],
              opt: GraphScheduleResult, w: TaskGraph) -> GraphPlan:
        per_dev: dict[str, list[str]] = {d.name: [] for d in devices}
        for i in opt.order:
            per_dev[devices[opt.assign[i]].name].append(w.nodes[i].name)
        return GraphPlan(
            assignments=tuple((name, tuple(tasks))
                              for name, tasks in per_dev.items()),
            assign=tuple(opt.assign), order=tuple(opt.order))

    def schedule(self, devices: Sequence[DeviceProfile], plan: GraphPlan,
                 w: TaskGraph) -> Schedule:
        spec = GraphTimelineSpec(devices=tuple(devices),
                                 tasks=w.task_specs(),
                                 edges=w.edge_indices(),
                                 assign=plan.assign, order=plan.order,
                                 topology=self.topology)
        tl = spec.rebase()
        ops = [0.0] * len(devices)
        for i, a in enumerate(plan.assign):
            ops[a] += float(w.nodes[i].ops)
        finish = [tl.device_finish(d.name) for d in devices]
        res = OptimizeResult(ops=ops, makespan=tl.makespan,
                             finish_times=finish, bus=self.bus)
        return Schedule(result=res, timeline=tl,
                        priorities=priority_order(list(devices)), spec=spec)

    def cost_signature(self, w: TaskGraph) -> Hashable:
        return w.cost_signature()


# ---------------------------------------------------------------------------
# Case-study builder: a transformer block as a DAG
# ---------------------------------------------------------------------------


def transformer_block(*, d_model: int = 4096, seq: int = 4096,
                      ff_mult: int = 4, groups: int = 4,
                      dtype_size: int = 2, name: str = "block",
                      d_ff: int | None = None) -> TaskGraph:
    """A transformer block (attention → residual → MLP) as a ``TaskGraph``.

    The QKV projection, attention, and both MLP matmuls are split into
    ``groups`` independent head/column groups — the DAG width co-execution
    exploits (each group is a self-contained chain, so the list scheduler
    can spread groups across devices while the projection/combine joins
    keep the precedence structure honest).  Ops are multiply-accumulates;
    bytes follow the activation/weight shapes at ``dtype_size``.

    Shapes per group g (d = d_model, s = seq, f = ff_mult*d, G = groups):
      qkv_g   (s,d)x(d,3d/G)   reads X + its weight slice, emits Q/K/V_g
      attn_g  scores+mix       2*s*s*(d/G) ops over Q/K/V_g, emits (s,d/G)
      proj    (s,d)x(d,d)      joins every attn_g, emits the residual input
      res1    elementwise add  s*d cheap ops (host-friendly)
      up_g    (s,d)x(d,f/G)    column-split first MLP matmul
      down_g  (s,f/G)x(f/G,d)  row-split second matmul (partial sums)
      combine sum of partials  joins every down_g, emits the block output
    """
    f = d_ff if d_ff is not None else ff_mult * d_model
    if groups < 1 or d_model % groups or f % groups:
        raise ValueError("groups must divide d_model and the FF width "
                         "(ff_mult*d_model, or d_ff when given)")
    d, s, G = d_model, seq, groups
    dg, fg = d // G, f // G
    x_bytes = float(s * d * dtype_size)          # one (s, d) activation
    nodes: list[TaskNode] = []
    edges: list[tuple[str, str]] = []

    for g in range(G):
        qkv = f"{name}.qkv{g}"
        attn = f"{name}.attn{g}"
        nodes.append(TaskNode(qkv, ops=float(s) * d * (3 * dg),
                              in_bytes=x_bytes + d * (3 * dg) * dtype_size,
                              out_bytes=float(s * 3 * dg * dtype_size)))
        nodes.append(TaskNode(attn, ops=2.0 * s * s * dg,
                              out_bytes=float(s * dg * dtype_size)))
        edges.append((qkv, attn))
        edges.append((attn, f"{name}.proj"))
    nodes.append(TaskNode(f"{name}.proj", ops=float(s) * d * d,
                          in_bytes=float(d * d * dtype_size),
                          out_bytes=x_bytes))
    nodes.append(TaskNode(f"{name}.res1", ops=float(s * d),
                          in_bytes=x_bytes, out_bytes=x_bytes))
    edges.append((f"{name}.proj", f"{name}.res1"))
    for g in range(G):
        up = f"{name}.up{g}"
        down = f"{name}.down{g}"
        nodes.append(TaskNode(up, ops=float(s) * d * fg,
                              in_bytes=float(d * fg * dtype_size),
                              out_bytes=float(s * fg * dtype_size)))
        nodes.append(TaskNode(down, ops=float(s) * fg * d,
                              in_bytes=float(fg * d * dtype_size),
                              out_bytes=x_bytes))
        edges.append((f"{name}.res1", up))
        edges.append((up, down))
        edges.append((down, f"{name}.combine"))
    nodes.append(TaskNode(f"{name}.combine", ops=float(s * d * G),
                          out_bytes=x_bytes))
    return TaskGraph(nodes=tuple(nodes), edges=tuple(edges))


def transformer_stack(config=None, *, layers: int | None = None,
                      microbatches: int = 1, seq: int = 4096,
                      groups: int = 4, dtype_size: int = 2,
                      name: str | None = None) -> TaskGraph:
    """A whole-model DAG: ``layers`` transformer blocks × ``microbatches``
    independent pipelines, shaped by a model from the in-repo config zoo.

    ``config`` is an ``ArchConfig``, a config name for
    ``configs.get_config`` (e.g. ``"stablelm-12b"``), or None for
    the default block geometry.  ``layers`` defaults to the config's
    ``num_layers``.  Each microbatch processes ``seq // microbatches``
    tokens through its own chain of blocks (block l feeds block l+1 —
    ``combine`` → every ``qkv`` group); distinct microbatches share no
    edges, which is the width the scheduler spreads across devices.  This
    is the 10²–10⁴-node regime the scheduler benchmark sweeps
    (``benchmarks/scheduler.py``), built from the same configs the rest of
    the repo trains, so graph scale tracks real model shapes.

    ``groups`` is clamped to the largest divisor of both widths not above
    the requested value, so any config is accepted as-is.
    """
    d_model, d_ff = 4096, 16384
    cfg_name = "block"
    if config is not None:
        if isinstance(config, str):
            from ..configs import get_config   # lazy: avoids a cycle
            cfg_name = config
            config = get_config(config)
        else:
            cfg_name = getattr(config, "name", "model")
        d_model = int(config.d_model)
        d_ff = int(config.d_ff)
        if layers is None:
            layers = int(config.num_layers)
    if layers is None:
        layers = 1
    if layers < 1 or microbatches < 1:
        raise ValueError("layers and microbatches must be >= 1")
    g = max(1, min(groups, d_model, d_ff))
    while d_model % g or d_ff % g:
        g -= 1
    seq_mb = max(1, seq // microbatches)
    base = name if name is not None else str(cfg_name)

    nodes: list[TaskNode] = []
    edges: list[tuple[str, str]] = []
    blocks: list[tuple[str, ...]] = []
    for m in range(microbatches):
        prev: str | None = None
        for l in range(layers):
            block = transformer_block(d_model=d_model, d_ff=d_ff,
                                      seq=seq_mb, groups=g,
                                      dtype_size=dtype_size,
                                      name=f"{base}.l{l}.m{m}")
            nodes.extend(block.nodes)
            edges.extend(block.edges)
            blocks.append(tuple(t.name for t in block.nodes))
            if prev is not None:
                for gi in range(g):
                    edges.append((prev, f"{base}.l{l}.m{m}.qkv{gi}"))
            prev = f"{base}.l{l}.m{m}.combine"
    return TaskGraph(nodes=tuple(nodes), edges=tuple(edges),
                     blocks=tuple(blocks))


def moe_block(*, d_model: int = 4096, seq: int = 4096,
              d_ff: int = 16384, experts: int = 8,
              experts_per_token: int = 2, groups: int = 4,
              dtype_size: int = 2, name: str = "moe") -> TaskGraph:
    """A mixture-of-experts transformer block as a ``TaskGraph``.

    The attention half is identical to ``transformer_block`` (grouped
    qkv → attn → proj → res1); the dense MLP is replaced by the MoE
    pattern: a cheap ``router`` fans out to ``experts`` *parallel* expert
    branches — each an ``up``/``down`` matmul pair over its token share
    ``seq * experts_per_token / experts`` — joined by a weighted
    ``combine``.  Every expert reads its OWN weight slab
    (``2 * d_model * d_ff`` bytes), so at low tokens-per-expert the DAG
    is copy-bound where the dense block is compute-bound — exactly the
    wide, link-pressured fan-out ALP co-execution is for.
    """
    f = d_ff
    if groups < 1 or d_model % groups:
        raise ValueError("groups must divide d_model")
    if experts < 1 or experts_per_token < 1 or experts_per_token > experts:
        raise ValueError("need 1 <= experts_per_token <= experts")
    d, s, G, E = d_model, seq, groups, experts
    dg = d // G
    tok_e = float(s) * experts_per_token / E    # tokens per expert
    x_bytes = float(s * d * dtype_size)
    nodes: list[TaskNode] = []
    edges: list[tuple[str, str]] = []

    for g in range(G):
        qkv = f"{name}.qkv{g}"
        attn = f"{name}.attn{g}"
        nodes.append(TaskNode(qkv, ops=float(s) * d * (3 * dg),
                              in_bytes=x_bytes + d * (3 * dg) * dtype_size,
                              out_bytes=float(s * 3 * dg * dtype_size)))
        nodes.append(TaskNode(attn, ops=2.0 * s * s * dg,
                              out_bytes=float(s * dg * dtype_size)))
        edges.append((qkv, attn))
        edges.append((attn, f"{name}.proj"))
    nodes.append(TaskNode(f"{name}.proj", ops=float(s) * d * d,
                          in_bytes=float(d * d * dtype_size),
                          out_bytes=x_bytes))
    nodes.append(TaskNode(f"{name}.res1", ops=float(s * d),
                          in_bytes=x_bytes, out_bytes=x_bytes))
    edges.append((f"{name}.proj", f"{name}.res1"))
    router = f"{name}.router"
    nodes.append(TaskNode(router, ops=float(s) * d * E,
                          in_bytes=float(d * E * dtype_size),
                          out_bytes=float(s * E * dtype_size)))
    edges.append((f"{name}.res1", router))
    for e in range(E):
        up = f"{name}.up{e}"
        down = f"{name}.down{e}"
        nodes.append(TaskNode(up, ops=tok_e * d * f,
                              in_bytes=float(d * f * dtype_size)
                              + tok_e * d * dtype_size,
                              out_bytes=tok_e * f * dtype_size))
        nodes.append(TaskNode(down, ops=tok_e * f * d,
                              in_bytes=float(f * d * dtype_size),
                              out_bytes=tok_e * d * dtype_size))
        edges.append((router, up))
        edges.append((up, down))
        edges.append((down, f"{name}.combine"))
    nodes.append(TaskNode(f"{name}.combine",
                          ops=float(s * d * experts_per_token),
                          out_bytes=x_bytes))
    return TaskGraph(nodes=tuple(nodes), edges=tuple(edges))


def moe_stack(config=None, *, layers: int | None = None,
              microbatches: int = 1, seq: int = 4096,
              experts: int | None = None,
              experts_per_token: int | None = None,
              moe_every: int | None = None,
              groups: int = 4, dtype_size: int = 2,
              name: str | None = None) -> TaskGraph:
    """A whole MoE model DAG from the in-repo config zoo — expert fan-out
    as parallel DAG branches (``moe_block``), dense ``transformer_block``
    layers interleaved per the config's ``moe_every`` stride.

    ``config`` is an ``ArchConfig``, a config name (``"dbrx-132b"``,
    ``"llama4-maverick-400b-a17b"``), or None for the default geometry;
    explicit keyword arguments override the config's
    ``num_experts``/``experts_per_token``/``moe_every``.  Layer l is a
    MoE layer when ``(l + 1) % moe_every == 0`` (llama4's interleaving
    convention), so ``moe_every=1`` makes every layer MoE (dbrx).  Same
    microbatch pipelining and group clamping as ``transformer_stack``.
    """
    d_model, d_ff = 4096, 16384
    cfg_name = "moe"
    if config is not None:
        if isinstance(config, str):
            from ..configs import get_config   # lazy: avoids a cycle
            cfg_name = config
            config = get_config(config)
        else:
            cfg_name = getattr(config, "name", "model")
        d_model = int(config.d_model)
        d_ff = int(config.d_ff)
        if layers is None:
            layers = int(config.num_layers)
        if experts is None and getattr(config, "num_experts", None):
            experts = int(config.num_experts)
        if experts_per_token is None \
                and getattr(config, "experts_per_token", None):
            experts_per_token = int(config.experts_per_token)
        if moe_every is None and getattr(config, "moe_every", None):
            moe_every = int(config.moe_every)
    layers = 1 if layers is None else layers
    experts = 8 if experts is None else experts
    experts_per_token = min(2, experts) if experts_per_token is None \
        else experts_per_token
    moe_every = 1 if moe_every is None else moe_every
    if layers < 1 or microbatches < 1 or moe_every < 1:
        raise ValueError("layers, microbatches and moe_every must be >= 1")
    g = max(1, min(groups, d_model, d_ff))
    while d_model % g or d_ff % g:
        g -= 1
    seq_mb = max(1, seq // microbatches)
    base = name if name is not None else str(cfg_name)

    nodes: list[TaskNode] = []
    edges: list[tuple[str, str]] = []
    blocks: list[tuple[str, ...]] = []
    for m in range(microbatches):
        prev: str | None = None
        for l in range(layers):
            bname = f"{base}.l{l}.m{m}"
            if (l + 1) % moe_every == 0:
                block = moe_block(d_model=d_model, d_ff=d_ff, seq=seq_mb,
                                  experts=experts,
                                  experts_per_token=experts_per_token,
                                  groups=g, dtype_size=dtype_size,
                                  name=bname)
            else:
                block = transformer_block(d_model=d_model, d_ff=d_ff,
                                          seq=seq_mb, groups=g,
                                          dtype_size=dtype_size,
                                          name=bname)
            nodes.extend(block.nodes)
            edges.extend(block.edges)
            blocks.append(tuple(t.name for t in block.nodes))
            if prev is not None:
                for gi in range(g):
                    edges.append((prev, f"{bname}.qkv{gi}"))
            prev = f"{bname}.combine"
    return TaskGraph(nodes=tuple(nodes), edges=tuple(edges),
                     blocks=tuple(blocks))


def ssm_block(*, d_model: int = 4096, seq: int = 4096,
              d_state: int = 128, expand: int = 2, head_dim: int = 64,
              ssm_groups: int = 1, chunk: int = 256, conv: int = 4,
              dtype_size: int = 2, name: str = "ssm") -> TaskGraph:
    """A mamba2-style SSD block as a ``TaskGraph`` — the scan-chain DAG
    shape (ROADMAP: whole-model DAGs beyond attention stacks).

    SSD (state-space duality) splits the sequence into chunks: each
    chunk's *intra* term is a quadratic attention-like matmul — chunks
    mutually independent, the DAG width — while the *inter* term carries
    a recurrent ``(d_inner, d_state)`` state chunk-to-chunk — a serial
    scan chain, the DAG depth.  That mix (wide independent quadratic
    work threaded by a cheap serial spine) is structurally unlike the
    transformer/MoE builders and exercises the scheduler's handling of
    long mandatory chains.

    Shapes (d = d_model, s = seq, di = expand*d, ds = d_state,
    nh = di/head_dim, G = ssm_groups, Q = s/chunks):
      inproj    (s,d)x(d,2di+2G*ds+nh)  z gate, x, B, C, dt in one matmul
      conv      depthwise K-tap conv over x/B/C (cheap, elementwise)
      intra{c}  2*Q^2*di ops            chunk-local attention-like term
      state{c}  2*Q*di*ds ops           state update; chains state{c-1}
      outproj   (s,di)x(di,d)           gated output projection
    ``state{c-1}`` also feeds ``intra{c}`` (the inter-chunk output
    contribution), and the final state joins ``outproj``; the state
    payload crossing chunks is ``di*ds`` fp32 bytes."""
    if d_model < 1 or seq < 1 or d_state < 1 or expand < 1:
        raise ValueError("d_model, seq, d_state and expand must be >= 1")
    d, s, ds, G = d_model, float(seq), d_state, ssm_groups
    di = expand * d_model
    nh = max(1, di // head_dim)
    conv_dim = di + 2 * G * ds
    w_in = 2 * di + 2 * G * ds + nh
    x_bytes = float(seq * d * dtype_size)
    n_chunks = max(1, seq // chunk)
    q = s / n_chunks                     # tokens per chunk
    nodes: list[TaskNode] = []
    edges: list[tuple[str, str]] = []

    inproj = f"{name}.inproj"
    cv = f"{name}.conv"
    outproj = f"{name}.outproj"
    nodes.append(TaskNode(inproj, ops=s * d * w_in,
                          in_bytes=x_bytes + float(d * w_in * dtype_size),
                          out_bytes=s * conv_dim * dtype_size))
    nodes.append(TaskNode(cv, ops=s * conv_dim * conv,
                          in_bytes=float(conv_dim * conv * dtype_size),
                          out_bytes=s * conv_dim * dtype_size))
    edges.append((inproj, cv))
    for c in range(n_chunks):
        intra = f"{name}.intra{c}"
        state = f"{name}.state{c}"
        nodes.append(TaskNode(intra, ops=2.0 * q * q * di,
                              out_bytes=q * di * dtype_size))
        nodes.append(TaskNode(state, ops=2.0 * q * di * ds,
                              out_bytes=float(di * ds * 4)))
        edges.append((cv, intra))
        edges.append((cv, state))
        if c > 0:
            edges.append((f"{name}.state{c-1}", state))
            edges.append((f"{name}.state{c-1}", intra))
        edges.append((intra, outproj))
    edges.append((f"{name}.state{n_chunks-1}", outproj))
    nodes.append(TaskNode(outproj, ops=s * di * d,
                          in_bytes=float(di * d * dtype_size),
                          out_bytes=x_bytes))
    return TaskGraph(nodes=tuple(nodes), edges=tuple(edges))


def ssm_stack(config=None, *, layers: int | None = None,
              microbatches: int = 1, seq: int = 4096,
              chunk: int | None = None, dtype_size: int = 2,
              name: str | None = None) -> TaskGraph:
    """A whole SSM model DAG from the in-repo config zoo (ROADMAP's open
    whole-model-DAG item): ``layers`` mamba2-style ``ssm_block``s ×
    ``microbatches`` independent pipelines, block l's ``outproj`` feeding
    block l+1's ``inproj``.  ``config`` is an ``ArchConfig``, a config
    name (``"mamba2-2_7b"``), or None for the default geometry; shapes
    (``d_model``, ``ssm_state``, ``ssm_expand``, ``ssm_head_dim``,
    ``ssm_chunk``, ``ssm_conv``, ``ssm_groups``) come from the config.
    Emits its block partition (``blocks``) like the other stack builders,
    so the template detector gets the per-layer tiling for free."""
    d_model, d_state, expand = 2560, 128, 2
    head_dim, ssm_groups, cfg_chunk, conv = 64, 1, 256, 4
    cfg_name = "ssm"
    if config is not None:
        if isinstance(config, str):
            from ..configs import get_config   # lazy: avoids a cycle
            cfg_name = config
            config = get_config(config)
        else:
            cfg_name = getattr(config, "name", "model")
        d_model = int(config.d_model)
        d_state = int(config.ssm_state) or d_state
        expand = int(config.ssm_expand)
        head_dim = int(config.ssm_head_dim)
        ssm_groups = int(getattr(config, "ssm_groups", 1))
        cfg_chunk = int(config.ssm_chunk)
        conv = int(getattr(config, "ssm_conv", 4))
        if layers is None:
            layers = int(config.num_layers)
    layers = 1 if layers is None else layers
    chunk = cfg_chunk if chunk is None else chunk
    if layers < 1 or microbatches < 1 or chunk < 1:
        raise ValueError("layers, microbatches and chunk must be >= 1")
    seq_mb = max(1, seq // microbatches)
    base = name if name is not None else str(cfg_name)

    nodes: list[TaskNode] = []
    edges: list[tuple[str, str]] = []
    blocks: list[tuple[str, ...]] = []
    for m in range(microbatches):
        prev: str | None = None
        for l in range(layers):
            bname = f"{base}.l{l}.m{m}"
            block = ssm_block(d_model=d_model, seq=seq_mb, d_state=d_state,
                              expand=expand, head_dim=head_dim,
                              ssm_groups=ssm_groups, chunk=chunk,
                              conv=conv, dtype_size=dtype_size, name=bname)
            nodes.extend(block.nodes)
            edges.extend(block.edges)
            blocks.append(tuple(t.name for t in block.nodes))
            if prev is not None:
                edges.append((prev, f"{bname}.inproj"))
            prev = f"{bname}.outproj"
    return TaskGraph(nodes=tuple(nodes), edges=tuple(edges),
                     blocks=tuple(blocks))


def diamond(ops: float = 1e9, *, bytes_per_edge: float = 1e6,
            width: int = 2, name: str = "dia") -> TaskGraph:
    """The textbook fork-join DAG (source → ``width`` parallel branches →
    sink) — the benchmark/test fixture where list scheduling visibly beats
    naive single-device placement."""
    nodes = [TaskNode(f"{name}.src", ops=ops / 10,
                      in_bytes=bytes_per_edge, out_bytes=bytes_per_edge)]
    edges: list[tuple[str, str]] = []
    for i in range(width):
        mid = f"{name}.mid{i}"
        nodes.append(TaskNode(mid, ops=ops, out_bytes=bytes_per_edge))
        edges.append((f"{name}.src", mid))
        edges.append((mid, f"{name}.sink"))
    nodes.append(TaskNode(f"{name}.sink", ops=ops / 10,
                          out_bytes=bytes_per_edge))
    return TaskGraph(nodes=tuple(nodes), edges=tuple(edges))


# ---------------------------------------------------------------------------
# Timeline invariant: dependencies respected
# ---------------------------------------------------------------------------


def verify_graph_dependencies(graph: TaskGraph | GraphTimelineSpec,
                              timeline: Timeline, *,
                              eps: float = 1e-9) -> list[str]:
    """The DAG invariant on a (planned or measured) timeline: no task's
    compute starts before every upstream task's output has landed —
    upstream compute finished, and any copy feeding this task's device
    completed.  Returns violations (empty = pass)."""
    if isinstance(graph, GraphTimelineSpec):
        edges = [(graph.tasks[u].name, graph.tasks[v].name)
                 for u, v in graph.edges]
    else:
        edges = list(graph.edges)
    problems: list[str] = []

    def compute_span(task: str) -> tuple[float, float] | None:
        evs = [e for e in timeline.task_events(task) if e.kind == "compute"]
        if not evs:
            return None
        return min(e.start for e in evs), max(e.end for e in evs)

    spans = {t: compute_span(t)
             for t in {name for edge in edges for name in edge}}
    for u, v in edges:
        su, sv = spans[u], spans[v]
        if su is None or sv is None:
            continue   # task not executed (partial assignment)
        if sv[0] < su[1] - eps:
            problems.append(f"task {v!r} computes at {sv[0]:.6g} before "
                            f"upstream {u!r} finished at {su[1]:.6g}")
    # every copy feeding a consumer (its copy_in events) must land before
    # that consumer computes — checked once per task, not once per edge
    for v in {b for _, b in edges}:
        sv = spans[v]
        if sv is None:
            continue
        for e in timeline.task_events(v):
            if e.kind == "copy_in" and sv[0] < e.end - eps:
                problems.append(f"task {v!r} computes at {sv[0]:.6g} "
                                f"before its input copy ended at {e.end:.6g}")
    return problems
