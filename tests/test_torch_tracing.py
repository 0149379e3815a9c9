"""The port's tracing (``repro_torch.tracing``) on the CPU: a span is the
profiler's range of its name; under ``torch.profiler`` the serving
engine's decode steps, the training step's phases and the MoE's stages
show as ranges that nest as their layers do; every range of the port is
opened through ``tracing`` and known to ``chip_smoke.py``."""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import tracing
from repro_torch.configs import get_tiny_config
from repro_torch.models import Model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.training import AdamW, init_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _ranges(prof) -> list:
    """(name, thread, start, end) of each range the profile holds, in the
    order they began."""
    got = [(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation()]
    return sorted(got, key=lambda r: r[2])


def _inside(inner, outer) -> bool:
    return outer[2] <= inner[2] <= inner[3] <= outer[3]


def _train_step(remat="full"):
    cfg = dataclasses.replace(get_tiny_config("hymba-1_5b"), remat=remat)
    torch.manual_seed(0)
    model = Model(cfg, device="cpu")
    opt = AdamW(learning_rate=1e-3)
    state = init_state(model, opt)
    rng = np.random.default_rng(5)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    return cfg, model, state, make_train_step(model, opt), batch


def test_a_span_is_the_profilers_range_of_its_name():
    s = tracing.span("model.decode_step")
    assert type(s) is record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with tracing.span("inner"):
                torch.ones(4).sum()
    (outer,), (inner,) = ([r for r in _ranges(prof) if r[0] == n]
                          for n in ("outer", "inner"))
    assert _inside(inner, outer) and inner[1] == outer[1]


def test_generate_runs_each_decode_step_under_its_span():
    max_new = 4
    torch.manual_seed(0)
    model = Model(get_tiny_config("minicpm3-4b"), device="cpu")
    rng = np.random.default_rng(3)
    reqs = [Request(uid, rng.integers(1, 256, n), max_new)
            for uid, n in ((11, 7), (12, 12), (13, 9))]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        done = ServingEngine(model).generate(reqs)
    ranges = _ranges(prof)
    # the prefill and the engine's glue open no range of the port
    assert [r[0] for r in ranges] == ["model.decode_step"] * (max_new - 1)
    assert len({r[1] for r in ranges}) == 1
    for a, b in zip(ranges, ranges[1:]):
        assert a[3] <= b[2]
    assert [len(c.tokens) for c in done] == [max_new] * len(reqs)


def test_a_remat_train_step_nests_its_phases_and_recompute():
    """The three phases once each, in order, on the step's thread; each
    layer's range once in the forward and, recomputed, once in the
    backward (on the CPU the autograd engine runs on the caller's
    thread)."""
    cfg, _, state, step, batch = _train_step("full")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    ranges = _ranges(prof)
    names = ["train_step.forward", "train_step.backward",
             "train_step.optimizer"]
    phases = [r for r in ranges if r[0] in names]
    assert [r[0] for r in phases] == names
    assert len({r[1] for r in phases}) == 1
    for a, b in zip(phases, phases[1:]):
        assert a[3] <= b[2]
    layers = [r for r in ranges if r[0] == "transformer.layer"]
    fwd, bwd = phases[0], phases[1]
    assert sum(_inside(r, fwd) for r in layers) == cfg.num_layers
    assert sum(_inside(r, bwd) for r in layers) == cfg.num_layers
    assert len(layers) == 2 * cfg.num_layers
    assert {r[0] for r in ranges} == set(names) | {"transformer.layer"}


def test_a_moe_layer_runs_its_four_stages_under_their_spans():
    """A tiny MoE model's forward: in each layer's range the router, the
    dispatch, the experts' products and the combine, once each and in
    that order."""
    cfg = get_tiny_config("dbrx-132b")
    torch.manual_seed(0)
    model = Model(cfg, device="cpu")
    rng = np.random.default_rng(7)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 12)))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model.loss({"tokens": tokens,
                        "labels": torch.roll(tokens, -1, 1)})
    ranges = _ranges(prof)
    layers = [r for r in ranges if r[0] == "transformer.layer"]
    stages = ["moe.router", "moe.dispatch", "moe.experts", "moe.combine"]
    assert len(layers) == cfg.num_layers
    for layer in layers:
        assert [r[0] for r in ranges
                if r[0] in stages and _inside(r, layer)] == stages
    assert sum(r[0] in stages for r in ranges) == 4 * cfg.num_layers


def _span_names() -> set:
    """The names of the port's spans: each ``span("...")`` call in
    ``src/repro_torch``."""
    names = set()
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "span" and node.args
                    and isinstance(node.args[0], ast.Constant)):
                names.add(node.args[0].value)
    return names


def test_every_range_of_the_port_is_a_span_named_where_it_is_read():
    """No ``record_function`` in the port outside ``tracing``; every span
    is listed in ``tracing``'s docstring and in ``chip_smoke.py``'s
    ``RANGES``, whose kernel lists leave the ranges' device rows out."""
    for path in PORT.rglob("*.py"):
        if path.name != "tracing.py" or path.parent != PORT:
            assert "record_function" not in path.read_text(), path
    names = _span_names()
    assert {"model.decode_step", "train_step.forward", "train_step.backward",
            "train_step.optimizer", "transformer.layer"} <= names
    doc = tracing.__doc__
    assert all(f"``{n}``" in doc for n in names), names
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            consts[node.targets[0].id] = node.value
    ranges = {n.value for key in ("RANGES", "MOE_RANGES")
              for n in ast.walk(consts[key]) if isinstance(n, ast.Constant)}
    assert names == ranges
