"""The task-graph domain of the port (``repro_torch.core.graph`` and the
runtime that executes its plans) is byte-identical to the JAX package's.

Each case builds the same input in both packages — a DAG from a graph constructor,
device profiles, a solver call, a ``TaskGraphDomain`` plan, a virtual-time
``CoExecutionRuntime`` stream — and reduces the result to plain values
(every dataclass field, every ``Timeline`` event, every ``ReplanRecord``,
every assignment and finish time), compared with ``==``, never
approximately.  The cases are those of ``tests/test_graph_scheduling.py``,
``test_template_tiling.py``, ``test_template_tiling_props.py`` (its
hypothesis strategy, derandomised), ``test_ssm_stack.py``,
``test_transformer_stack.py``, ``test_scheduler_incremental.py``,
``test_resolve_fastpath.py`` and the virtual-time runs of
``test_replanning.py`` and ``test_multi_tenant.py``, plus the
``moe_stack`` / ``transformer_stack`` DAGs of dbrx-132b and
llama4-maverick-400b-a17b from each package's own configs.
"""
import dataclasses
import importlib
import math
import random

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

ROOTS = ("repro", "repro_torch")


def _mod(root, name="core"):
    return importlib.import_module(f"{root}.{name}")


def canon(x):
    """``x`` as nested tuples of plain values, free of the defining
    classes (the two packages define equal but distinct classes)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, canon(getattr(x, f.name)))
            for f in dataclasses.fields(x) if not f.name.startswith("_"))
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted(((canon(k), canon(v)) for k, v in x.items()),
                            key=repr))
    if isinstance(x, (set, frozenset)):
        return tuple(sorted((canon(v) for v in x), key=repr))
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"no canonical form for {type(x).__name__}")


def same(case):
    """Run ``case(root)`` in both packages; their canonical results must
    be equal.  Returns the port's."""
    want, got = (canon(case(root)) for root in ROOTS)
    assert got == want
    return got


# ---------------------------------------------------------------- devices --


def _dev(c, name, tflops, bw=None, b=1e-4):
    ops_per_s = tflops * 1e12 / 2
    copy = c.NO_COPY if bw is None else c.CopyModel(bw, dtype_size=4)
    return c.DeviceProfile(name, "gpu" if bw else "cpu",
                           c.LinearTimeModel(a=1 / ops_per_s, b=b), copy)


def _devices(c):
    """A host CPU plus two PCIe accelerators of different speeds
    (``tests/test_graph_scheduling.py``)."""
    return [_dev(c, "cpu", 0.5), _dev(c, "gpu", 6.0, bw=16e9),
            _dev(c, "xpu", 12.0, bw=16e9)]


def _devs(c):
    """``tests/test_template_tiling.py``'s three devices."""
    return [
        c.DeviceProfile("cpu", "cpu", c.LinearTimeModel(a=1 / 5e12, b=1e-4),
                        c.NO_COPY),
        c.DeviceProfile("gpu0", "gpu",
                        c.LinearTimeModel(a=1 / 60e12, b=5e-5),
                        c.CopyModel(16e9, dtype_size=4)),
        c.DeviceProfile("gpu1", "gpu",
                        c.LinearTimeModel(a=1 / 25e12, b=8e-5),
                        c.CopyModel(8e9, dtype_size=4)),
    ]


DEVICE_SETS = {"three": _devices, "tiling": _devs,
               "paper_mach1": lambda c: c.paper_mach1(),
               "paper_mach2": lambda c: c.paper_mach2()}


# ----------------------------------------------------------------- graphs --


def _chain(c, n=3, ops=1e9, out_bytes=1e6):
    nodes = tuple(c.TaskNode(f"t{i}", ops, in_bytes=out_bytes,
                             out_bytes=out_bytes) for i in range(n))
    edges = tuple((f"t{i}", f"t{i+1}") for i in range(n - 1))
    return c.TaskGraph(nodes=nodes, edges=edges)


def _five(c):
    return c.TaskGraph(
        nodes=(c.TaskNode("a", 4e9, out_bytes=4e6),
               c.TaskNode("b", 6e9, out_bytes=1e6),
               c.TaskNode("c", 2e9, out_bytes=1e6),
               c.TaskNode("d", 9e9, in_bytes=32e6, out_bytes=8e6),
               c.TaskNode("e", 1e9, out_bytes=1e6)),
        edges=(("a", "c"), ("b", "c"), ("c", "e"), ("d", "e")))


def _chain_of_blocks(c, repeats, *, perturb=None, with_blocks=True):
    """``tests/test_template_tiling.py``: 4-node diamonds chained
    tail→head; ``perturb`` bumps one node's ops in that block."""
    nodes, edges, blocks = [], [], []
    for r in range(repeats):
        ops = [4e11, 2e11, 3e11, 1e11]
        if r == perturb:
            ops[1] *= 1.5
        names = [f"b{r}.n{k}" for k in range(4)]
        nodes += [c.TaskNode(names[0], ops=ops[0], in_bytes=1e6,
                             out_bytes=2e6),
                  c.TaskNode(names[1], ops=ops[1], out_bytes=1e6),
                  c.TaskNode(names[2], ops=ops[2], out_bytes=1e6),
                  c.TaskNode(names[3], ops=ops[3], out_bytes=2e6)]
        edges += [(names[0], names[1]), (names[0], names[2]),
                  (names[1], names[3]), (names[2], names[3])]
        if r > 0:
            edges.append((f"b{r-1}.n3", names[0]))
        blocks.append(tuple(names))
    return c.TaskGraph(nodes=tuple(nodes), edges=tuple(edges),
                       blocks=tuple(blocks) if with_blocks else ())


GRAPHS = {
    "chain3": lambda c: _chain(c, 3),
    "chain5": lambda c: _chain(c, 5),
    "five": _five,
    "diamond2": lambda c: c.diamond(ops=8e9, width=2),
    "diamond3-copy-heavy": lambda c: c.diamond(ops=8e9, bytes_per_edge=64e6,
                                               width=3),
    "diamond4": lambda c: c.diamond(ops=5e9, width=4),
    "block-1024x2048": lambda c: c.transformer_block(d_model=1024, seq=2048,
                                                     groups=4),
    "block-2048x4096": lambda c: c.transformer_block(d_model=2048, seq=4096,
                                                     groups=4),
    "block-default": lambda c: c.transformer_block(),
    "moe-block": lambda c: c.moe_block(d_model=1024, seq=1024, d_ff=4096),
    "ssm-block": lambda c: c.ssm_block(d_model=1024, seq=2048, chunk=256),
    "ssm-block-512": lambda c: c.ssm_block(d_model=512, seq=4096, chunk=256),
    "transformer-stack-2x3": lambda c: c.transformer_stack(
        layers=2, microbatches=3, groups=4),
    "transformer-stack-6x2": lambda c: c.transformer_stack(
        layers=6, microbatches=2, groups=4),
    "transformer-stack-split": lambda c: c.transformer_stack(
        layers=1, microbatches=4, seq=4096),
    "stablelm-stack": lambda c: c.transformer_stack(
        "stablelm-12b", layers=4, microbatches=2, groups=4),
    "ssm-stack-mamba2": lambda c: c.ssm_stack("mamba2-2_7b", layers=2,
                                              microbatches=1, seq=8192),
    "ssm-stack-5x2": lambda c: c.ssm_stack(layers=5, microbatches=2,
                                           seq=2048, chunk=512),
    "chain-of-blocks-8": lambda c: _chain_of_blocks(c, 8),
    "chain-of-blocks-8-perturbed": lambda c: _chain_of_blocks(c, 8,
                                                              perturb=3),
    "chain-of-blocks-8-bare": lambda c: _chain_of_blocks(
        c, 8, with_blocks=False),
    "dbrx-moe-stack": lambda c: c.moe_stack("dbrx-132b", layers=4,
                                            microbatches=2),
    "dbrx-moe-stack-full-depth": lambda c: c.moe_stack("dbrx-132b"),
    "dbrx-transformer-stack": lambda c: c.transformer_stack(
        "dbrx-132b", layers=3, microbatches=2),
    "llama4-moe-stack": lambda c: c.moe_stack(
        "llama4-maverick-400b-a17b", layers=2),
    "llama4-moe-stack-2x2": lambda c: c.moe_stack(
        "llama4-maverick-400b-a17b", layers=2, microbatches=2),
    "llama4-transformer-stack": lambda c: c.transformer_stack(
        "llama4-maverick-400b-a17b", layers=2, microbatches=2),
}


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_graph_constructors_byte_identical(graph):
    """The DAG itself and every query the solver and cache make of it."""
    def case(root):
        c = _mod(root)
        g = GRAPHS[graph](c)
        return (g, g.topo_order(), g.critical_path(), g.total_ops(),
                g.cost_signature(), g.task_specs(), g.edge_indices(),
                g.template_partition(), g.template_partition(min_repeats=2),
                c.detect_templates(g, min_repeats=2))
    same(case)


SOLVED = ["chain5", "five", "diamond3-copy-heavy", "diamond4",
          "block-1024x2048", "moe-block", "ssm-block", "chain-of-blocks-8",
          "dbrx-moe-stack"]


@pytest.mark.parametrize("devices", ["three", "tiling", "paper_mach1"])
@pytest.mark.parametrize("graph", SOLVED)
def test_list_schedule_and_engine_byte_identical(graph, devices):
    """``solve_list_schedule`` (refined, EFT only, naive topo priority),
    the engine's timeline of its assignment, carried clocks, and every
    single-device schedule."""
    def case(root):
        c = _mod(root)
        g, devs = GRAPHS[graph](c), DEVICE_SETS[devices](c)
        specs, edges = g.task_specs(), g.edge_indices()
        res = c.solve_list_schedule(devs, specs, edges, bus="serialized")
        eft = c.solve_list_schedule(devs, specs, edges, bus="serialized",
                                    refine=False)
        naive = c.solve_list_schedule(devs, specs, edges, bus="serialized",
                                      priority="topo", refine=False)
        tl = c.simulate_graph_timeline(devs, specs, edges, res.assign,
                                       topology="serialized",
                                       order=res.order)
        again = c.build_graph_timeline(devs, specs, edges, res.assign,
                                       topology="serialized",
                                       order=res.order,
                                       clocks=c.carry_clocks(tl))
        singles = [c.graph_finish_times(devs, specs, edges, [j] * len(g),
                                        topology="serialized",
                                        order=res.order)
                   for j in range(len(devs))]
        return (res, eft, naive, tl, again, singles,
                c.verify_graph_dependencies(g, tl))
    same(case)


def test_brute_force_optimum_byte_identical():
    """The small-instance exact mode and the enumerated optimum
    (``test_list_schedule_equals_brute_force_on_small_graphs``)."""
    def case(root):
        c = _mod(root)
        devs = _devices(c)
        out = []
        for name in ("chain3", "diamond2", "diamond3-copy-heavy", "five"):
            g = GRAPHS[name](c)
            res = c.solve_list_schedule(devs, g.task_specs(),
                                        g.edge_indices(), bus="serialized")
            out.append((res, [max(c.graph_finish_times(
                devs, g.task_specs(), g.edge_indices(), list(a),
                topology="serialized", order=res.order))
                for a in np.ndindex(*(3,) * len(g))]))
        return out
    same(case)


@pytest.mark.parametrize("graph", ["chain-of-blocks-8", "transformer-stack-6x2",
                                   "stablelm-stack", "ssm-stack-5x2",
                                   "dbrx-moe-stack", "llama4-moe-stack-2x2"])
def test_hierarchical_solve_byte_identical(graph):
    """Template-tiled solves, the template cache's hits and misses, and
    the engine's ground truth of the stitched assignment."""
    def case(root):
        c = _mod(root)
        devs = _devs(c)
        g = GRAPHS[graph](c)
        part = g.template_partition(min_repeats=2)
        cache = c.TemplatePlanCache()
        r = c.solve_hierarchical(devs, g.task_specs(), g.edge_indices(),
                                 partition=part, template_cache=cache)
        r2 = c.solve_hierarchical(devs, g.task_specs(), g.edge_indices(),
                                  partition=part, template_cache=cache)
        truth = c.graph_finish_times(
            devs, g.task_specs(), g.edge_indices(), r.assign,
            topology=c.BusTopology.from_spec("serialized", devs),
            order=r.order)
        return r, r2, truth, (cache.hits, cache.misses, len(cache))
    same(case)


def test_template_cache_across_depths_byte_identical():
    def case(root):
        c = _mod(root)
        devs, cache = _devs(c), c.TemplatePlanCache()
        out = []
        for layers in (6, 20):
            g = c.transformer_stack(layers=layers, microbatches=1, groups=4)
            out.append(c.solve_hierarchical(
                devs, g.task_specs(), g.edge_indices(),
                partition=g.template_partition(), template_cache=cache))
            out.append((cache.hits, cache.misses))
        return out
    same(case)


def _plan_record(plan):
    spec = plan.schedule.spec
    return (plan, spec.rebase(), spec.ops_by_device())


@pytest.mark.parametrize("devices", ["three", "tiling", "paper_mach2"])
@pytest.mark.parametrize("graph", ["block-1024x2048", "transformer-stack-6x2",
                                   "ssm-stack-5x2", "dbrx-moe-stack",
                                   "llama4-moe-stack", "diamond4"])
@pytest.mark.parametrize("hierarchical", ["auto", False])
def test_domain_plan_byte_identical(graph, devices, hierarchical):
    """The four phases through ``POAS(TaskGraphDomain)``: optimize result,
    the adapt phase's ``GraphPlan``, the schedule's timeline and spec, its
    rebase, and the plan cache's hits on a structurally equal graph."""
    def case(root):
        c = _mod(root)
        dom = c.TaskGraphDomain(DEVICE_SETS[devices](c), bus="serialized",
                                hierarchical=hierarchical)
        poas = c.POAS(dom, cache=c.PlanCache())
        p1 = poas.plan(GRAPHS[graph](c))
        p2 = poas.plan(GRAPHS[graph](c))
        g = GRAPHS[graph](c)
        return (_plan_record(p1), p2.schedule is p1.schedule,
                poas.cache.stats(),
                c.verify_graph_dependencies(g, p1.schedule.timeline))
    same(case)


def test_partial_solves_byte_identical():
    """Pinned tasks, external (compute_end, avail) prices, an infinite
    avail, frontier extraction and ``rebase_partial``
    (``tests/test_replanning.py``)."""
    def case(root):
        c = _mod(root)
        devs = _devices(c)
        g = c.diamond(ops=8e9, width=3)
        pinned = c.solve_list_schedule(devs, g.task_specs(),
                                       g.edge_indices(), bus="serialized",
                                       pinned={0: 0, 1: 1})
        h = c.TaskGraph(nodes=(c.TaskNode("a", 4e9, out_bytes=8e6),
                               c.TaskNode("b", 4e9, out_bytes=8e6),
                               c.TaskNode("c", 1e9)),
                        edges=(("a", "b"), ("b", "c")))
        specs, edges = h.task_specs(), h.edge_indices()
        ext = c.solve_list_schedule(devs, specs, edges, bus="serialized",
                                    pinned={0: 2, 1: 1},
                                    ext={0: (0.04, 0.05)})
        never = c.solve_list_schedule(devs, specs, edges, bus="serialized",
                                      pinned={0: 2},
                                      ext={0: (0.04, math.inf)})
        f = c.TaskGraph(nodes=(c.TaskNode("a", 1e9, out_bytes=4e6),
                               c.TaskNode("b", 2e9, in_bytes=1e6,
                                          out_bytes=1e6),
                               c.TaskNode("c", 3e9)),
                        edges=(("a", "b"), ("b", "c")))
        plan = c.POAS(c.TaskGraphDomain(devs, bus="serialized")).plan(
            GRAPHS["block-1024x2048"](c))
        spec = plan.schedule.spec
        frozen = spec.tasks[spec.order[0]].name
        return (pinned, ext, never, f.frontier_subgraph({"a"}),
                f.frontier_subgraph(set()),
                spec.rebase_partial(ext={frozen: (1e-3, 2e-3)}))
    same(case)


# ------------------------------------ incremental engine, seeded DAGs -------


def _random_case(c, rng, n_lo=3, n_hi=14):
    """``tests/test_resolve_fastpath.py``'s generator."""
    n = rng.randint(n_lo, n_hi)
    edges = tuple((u, v) for u in range(n) for v in range(u + 1, n)
                  if rng.random() < 0.35)
    tasks = [c.TaskSpec(name=f"t{i}",
                        ops=rng.choice([0.0, rng.uniform(0.0, 1e12)]),
                        in_bytes=rng.choice([0.0, rng.uniform(1e3, 1e9)]),
                        out_bytes=rng.choice([0.0, rng.uniform(1e3, 1e9)]))
             for i in range(n)]
    return tasks, edges


def _ctx(c, tasks, edges, devs, **kw):
    topo = c.BusTopology.from_spec("serialized", devs)
    return c.GraphSimContext(devs, tasks, edges, topo,
                             list(range(len(tasks))), **kw)


@pytest.mark.parametrize("seed", [0x5EED, 0xB0D, 0xCAFE])
def test_descent_and_bounded_advance_byte_identical(seed):
    """Pruned and full descents from random seeds, bounded ``advance``
    at and below the makespan, and budgeted re-solves
    (``tests/test_resolve_fastpath.py``)."""
    def case(root):
        c, opt = _mod(root), _mod(root, "core.optimize")
        rng = random.Random(seed)
        devs = _devs(c)
        out = []
        for _ in range(12):
            tasks, edges = _random_case(c, rng)
            n = len(tasks)
            ctx = _ctx(c, tasks, edges, devs)
            assign = [rng.randrange(len(devs)) for _ in range(n)]
            for prune in (True, False):
                out.append(opt._descend_assign(ctx, list(assign),
                                               max_evals=60, prune=prune))
            full = c.GraphSimState(ctx, list(assign))
            full.advance(n)
            span = max(full.finish)
            for bound in (math.inf, span, span * rng.uniform(0.1, 1.0)):
                st_ = c.GraphSimState(ctx, list(assign))
                out.append((st_.advance(n, bound=bound), st_.finish,
                            st_.compute_end, st_.avail))
            for cap in (3, 10, 60):
                out.append(c.solve_list_schedule(
                    devs, tasks, edges, refine=True, seed_assign=assign,
                    max_evals=cap))
        return out
    same(case)


def test_context_cache_resolves_byte_identical():
    def case(root):
        c, opt = _mod(root), _mod(root, "core.optimize")
        rng = random.Random(0xCAC4E)
        devs = _devs(c)
        tasks, edges = _random_case(c, rng, n_lo=8, n_hi=14)
        n = len(tasks)
        cache = opt.SolveContextCache()
        out = []
        for _ in range(6):
            full = c.solve_list_schedule(devs, tasks, edges, refine=False)
            done = list(full.order)[:rng.randint(1, n - 1)]
            kw = dict(refine=True,
                      pinned={i: full.assign[i] for i in done},
                      ext={i: (full.task_finish[i], full.task_finish[i])
                           for i in done},
                      clocks=c.ClockState(devices={
                          d.name: rng.uniform(0.0, 0.005) for d in devs},
                          floor=0.0),
                      seed_assign=list(full.assign), max_evals=40)
            out.append(c.solve_list_schedule(devs, tasks, edges,
                                             cache=cache, **kw))
        return out
    same(case)


def test_price_lanes_and_peeks_byte_identical():
    """Scalar ``peek_finish``, ``_peek_batch`` and fused ``price_lanes``
    under random external prices and clocks."""
    def case(root):
        c, opt = _mod(root), _mod(root, "core.optimize")
        rng = random.Random(0xFA57)
        devs = _devs(c)
        out = []
        for _ in range(12):
            tasks, edges = _random_case(c, rng)
            n = len(tasks)
            ext = {}
            for i in range(n):
                if rng.random() < 0.25:
                    ce = rng.uniform(0.0, 0.02)
                    ext[i] = (ce, math.inf if rng.random() < 0.3
                              else ce + rng.uniform(0.0, 0.01))
            ctx = _ctx(c, tasks, edges, devs, ext=ext, clocks=c.ClockState(
                devices={d.name: rng.uniform(0, 0.01) for d in devs},
                floor=0.0))
            sim = c.GraphSimState(ctx, [-1] * n, placed=list(ext))
            da = opt._DeviceArrays(ctx)
            for pos, i in enumerate(ctx.order):
                if i not in ext:
                    out.append((sim.price_lanes(i, len(devs)),
                                [float(v) for v in opt._peek_batch(sim, da,
                                                                   i)]))
                    sim.assign[i] = rng.randrange(len(devs))
                sim.placed[i] = 1
                sim.advance(pos + 1)
            out.append(sim.finish)
        return out
    same(case)


_bytes = st.one_of(st.just(0.0), st.floats(1e3, 1e9))


@st.composite
def _dag(draw):
    """``tests/test_scheduler_incremental.py``'s strategy, drawn as plain
    values so both packages build the same DAG from them."""
    n = draw(st.integers(2, 8))
    edges = tuple((u, v) for u in range(n) for v in range(u + 1, n)
                  if draw(st.booleans()))
    tasks = [(f"t{i}", draw(st.floats(0.0, 1e12)), draw(_bytes),
              draw(_bytes)) for i in range(n)]
    assign = [draw(st.integers(-1, 2)) for _ in range(n)]
    clocks = [draw(st.floats(0.0, 0.01)) for _ in range(4)]
    cuts = sorted(draw(st.lists(st.integers(0, n), max_size=3)))
    pinned = {i: draw(st.integers(0, 2)) for i in range(n)
              if draw(st.booleans())}
    return tasks, edges, assign, clocks, cuts, pinned


@settings(max_examples=25, deadline=None, derandomize=True)
@given(case=_dag())
def test_incremental_engine_byte_identical(case):
    """Chunked ``GraphSimState.advance`` under carried clocks, the
    from-scratch engine, and pinned EFT placements."""
    tasks, edges, assign, clocks, cuts, pinned = case

    def run(root):
        c = _mod(root)
        devs = _devs(c)
        specs = [c.TaskSpec(name=nm, ops=o, in_bytes=i, out_bytes=b)
                 for nm, o, i, b in tasks]
        topo = c.BusTopology.from_spec("serialized", devs)
        cs = c.ClockState(devices={d.name: t for d, t in zip(devs, clocks)},
                          floor=clocks[3])
        ctx = c.GraphSimContext(devs, specs, edges, topo,
                                list(range(len(specs))), clocks=cs)
        state = c.GraphSimState(ctx, list(assign))
        for cut in cuts:
            state.advance(cut)
        state.advance(len(specs))
        return (state.finish,
                c.graph_finish_times(devs, specs, edges, assign,
                                     topology=topo, clocks=cs),
                c.solve_list_schedule(devs, specs, edges, bus=topo,
                                      refine=False, pinned=pinned),
                c.solve_list_schedule(devs, specs, edges, bus=topo))
    same(run)


@st.composite
def _tiled_graph(draw):
    """``tests/test_template_tiling_props.py``'s strategy as plain values:
    R repeats of one random block, chained tail→head."""
    k = draw(st.integers(2, 5))
    block_edges = tuple((u, v) for u in range(k) for v in range(u + 1, k)
                        if draw(st.booleans()))
    costs = [(draw(st.floats(1e8, 1e12)), draw(_bytes), draw(_bytes))
             for _ in range(k)]
    return k, block_edges, costs, draw(st.integers(4, 7))


@settings(max_examples=15, deadline=None, derandomize=True)
@given(case=_tiled_graph())
def test_tiled_solve_byte_identical(case):
    k, block_edges, costs, repeats = case

    def run(root):
        c = _mod(root)
        nodes, edges, blocks = [], [], []
        for r in range(repeats):
            names = [f"b{r}.n{i}" for i in range(k)]
            nodes += [c.TaskNode(names[i], ops=o, in_bytes=a, out_bytes=b)
                      for i, (o, a, b) in enumerate(costs)]
            edges += [(names[u], names[v]) for u, v in block_edges]
            if r > 0:
                edges.append((f"b{r-1}.n{k-1}", names[0]))
            blocks.append(tuple(names))
        g = c.TaskGraph(nodes=tuple(nodes), edges=tuple(edges),
                        blocks=tuple(blocks))
        devs = _devs(c)
        part = g.template_partition(min_repeats=2)
        return part, c.solve_hierarchical(
            devs, g.task_specs(), g.edge_indices(), partition=part,
            template_cache=c.TemplatePlanCache())
    same(run)


# --------------------------------------------- virtual-time streams -------


def _job(j):
    """A streamed job as plain values: its plan, planned and measured
    timelines, every re-plan record, and how it ended."""
    return (j.uid, j.plan, j.planned, j.measured, j.replans,
            j.epoch_at_plan, j.arrival, j.deadline, j.vstart, j.vft,
            type(j.error).__name__ if j.error is not None else None,
            j.final_spec if j.plan is not None else None)


def _block(c):
    return c.transformer_block(d_model=1024, seq=2048, groups=4)


def _throttled(c, at=0, factor=6.0, device="xpu"):
    return c.truth_from_profiles(
        _devices(c), lambda uid, name: factor if uid >= at and name == device
        else 1.0)


def _stream(c, workloads, *, truth, **kw):
    dom = c.TaskGraphDomain(_devices(c), bus="serialized", dynamic=True)
    with c.CoExecutionRuntime(dom, executor="virtual", truth=truth,
                              **kw) as rt:
        jobs = rt.run_stream(workloads)
        return ([_job(j) for j in jobs], rt.stats(),
                rt.stream_timeline(), c.verify_stream_invariants(jobs))


STREAMS = {
    # test_graph_scheduling.py: dependencies and the per-task re-fit
    "dependencies": lambda c: _stream(
        c, [c.transformer_block(d_model=1024, seq=1024, groups=4)] * 6,
        truth=_throttled(c, at=2, factor=3.0), feedback=True,
        max_inflight=1),
    "round-trip-refit": lambda c: _stream(
        c, [c.transformer_block(d_model=1024, seq=1024, groups=4)] * 8,
        truth=_throttled(c, at=2, factor=3.0), feedback=True,
        max_inflight=1),
    # test_replanning.py: locked-in vs re-planned, no straggler, a stream
    # of four, and the copy-slack monitor
    "locked-in": lambda c: _stream(
        c, [_block(c)], truth=_throttled(c), feedback=True, max_inflight=1,
        replan=False, straggler_threshold=1.3),
    "replan": lambda c: _stream(
        c, [_block(c)], truth=_throttled(c), feedback=True, max_inflight=1,
        replan=True, straggler_threshold=1.3),
    "replan-stream-of-4": lambda c: _stream(
        c, [_block(c)] * 4, truth=_throttled(c), feedback=True,
        max_inflight=1, replan=True, straggler_threshold=1.3),
    "replan-noop": lambda c: _stream(
        c, [_block(c)] * 3, truth=c.truth_from_profiles(_devices(c)),
        feedback=True, max_inflight=1, replan=True),
    "copy-straggler": lambda c: _stream(
        c, [_block(c)], truth=c.truth_from_profiles(
            _devices(c), copy_slowdown=lambda uid, name:
            10.0 if name == "xpu" else 1.0),
        feedback=True, max_inflight=1, replan=True, straggler_threshold=1.3),
    "carried-clocks-two-inflight": lambda c: _stream(
        c, [_block(c), c.diamond(ops=2e9, width=3)] * 3,
        truth=_throttled(c, at=1, factor=2.0), feedback=True,
        carry_clocks=True, max_inflight=2),
}


@pytest.mark.parametrize("stream", list(STREAMS))
def test_virtual_stream_byte_identical(stream):
    """Every job's plan, timelines and ``ReplanRecord``s, the runtime's
    stats, and the stream's carried timeline."""
    same(lambda root: STREAMS[stream](_mod(root)))


def test_gemm_stream_stats_byte_identical():
    """A divisible-workload stream through the same runtime
    (``test_stats_percentiles_use_nearest_rank``)."""
    def case(root):
        c = _mod(root)
        dom = c.GemmDomain(c.paper_mach1(), bus="serialized")
        with c.CoExecutionRuntime(dom, executor="virtual", feedback=False,
                                  max_inflight=1) as rt:
            jobs = rt.run_stream([c.GemmWorkload(1024, 1024, 1024),
                                  c.GemmWorkload(2048, 2048, 2048)])
            return [_job(j) for j in jobs], rt.stats()
    same(case)


def _tenants(c, *, deadline=None, latency_at=None, batches=2):
    """``tests/test_multi_tenant.py``: a batch tenant and a latency-tier
    tenant sharing one virtual runtime, preemption on."""
    truth = c.truth_from_profiles(_devices(c))
    rt = c.CoExecutionRuntime(None, executor="virtual", truth=truth,
                              feedback=True, max_inflight=2, preempt=True)
    try:
        dom = lambda: c.TaskGraphDomain(_devices(c), bus="serialized",  # noqa: E731
                                        dynamic=True)
        batch = rt.register("batch", dom(), c.QoS(weight=1.0))
        lat = rt.register("lat", dom(), c.QoS(weight=4.0,
                                               tier=c.TIER_LATENCY))
        rt.pause_admission()
        jobs = [batch.submit(_block(c), arrival=0.0) for _ in range(batches)]
        jobs.append(lat.submit(c.diamond(ops=2e9, width=3),
                               arrival=latency_at))
        rt.resume_admission()
        rt.drain()
        return ([_job(j) for j in jobs], rt.stats(), rt.stream_timeline(),
                c.verify_stream_invariants(jobs))
    finally:
        rt.shutdown()


def _solo_makespan(c):
    with c.CoExecutionRuntime(
            c.TaskGraphDomain(_devices(c), bus="serialized", dynamic=True),
            executor="virtual", truth=c.truth_from_profiles(_devices(c)),
            max_inflight=1) as probe:
        return probe.run_stream([_block(c)])[0].measured.makespan


TENANTS = {
    "preemption-mid-job": lambda c: _tenants(
        c, latency_at=0.5 * _solo_makespan(c)),
    "preemption-fairness-stats": lambda c: _tenants(c, latency_at=0.004,
                                                    batches=3),
}


@pytest.mark.parametrize("run", list(TENANTS))
def test_multi_tenant_stream_byte_identical(run):
    same(lambda root: TENANTS[run](_mod(root)))


def test_admission_rejection_byte_identical():
    """An infeasible deadline is rejected before dispatch, per job and
    from a tenant's ``QoS``; a feasible one runs."""
    def case(root):
        c = _mod(root)
        truth = c.truth_from_profiles(_devices(c))
        dom = c.TaskGraphDomain(_devices(c), bus="serialized", dynamic=True)
        with c.CoExecutionRuntime(dom, executor="virtual", truth=truth,
                                  max_inflight=1) as rt:
            bad = rt.submit(_block(c), deadline_s=1e-6)
            with pytest.raises(c.AdmissionRejected):
                bad.wait(30)
            ok = rt.submit(_block(c), deadline_s=10.0).wait(30)
            out = ([_job(bad), _job(ok)], bad.rejected,
                   (bad.error.predicted, bad.error.deadline), rt.stats())
        rt2 = c.CoExecutionRuntime(None, executor="virtual", truth=truth,
                                   max_inflight=1)
        try:
            ten = rt2.register("strict", c.TaskGraphDomain(
                _devices(c), bus="serialized", dynamic=True),
                c.QoS(deadline_s=1e-6))
            j = ten.submit(_block(c))
            with pytest.raises(c.AdmissionRejected):
                j.wait(30)
            return out, _job(j), ten.rejected
        finally:
            rt2.shutdown()
    same(case)


def test_domains_are_the_reference_domains():
    ref, port = _mod("repro"), _mod("repro_torch")
    assert port.list_domains() == ref.list_domains() == [
        "gemm", "serving-dispatch", "task-graph", "train-step"]
    assert isinstance(port.get_domain("task-graph", _devices(port)),
                      port.TaskGraphDomain)
