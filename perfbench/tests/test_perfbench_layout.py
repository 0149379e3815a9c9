"""BENCHMARK.json against the contract's shape, the harness finding what a
later change adds as files alone, and the whole-name check for JAX."""
from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest
from conftest import ROOT, run_cell

from perfbench.harness.cli import forbidden_modules
from perfbench.harness.registry import Registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    doc = json.loads((ROOT / entry["file"]).read_text())
    assert doc["name"] == entry["name"] and doc["reduced"] == entry["reduced"]


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_entry(cell):
    reg = Registry(ROOT)
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] in (1, 4)
    assert len(cell["why"]) <= 200
    reg.config(cell["config"])
    assert reg.traffic(cell["traffic"])["kind"]
    assert reg.limits(cell["name"])["numbers"]
    names = {m["name"] for m in reg.metrics(cell["name"], False)}
    assert "setup_s" in names and len(names) >= 2
    assert reg.metrics(cell["name"], True)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in SPEC["per_layer"]:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        moved = next(m for m in SPEC["end_to_end"]
                     if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
        assert (ROOT / "perfbench" / "metrics"
                / f"{metric['name']}.py").exists()
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_later_change_adds_by_files_alone(tiny, capsys):
    """A configuration, a mix, a per-layer metric and a cell added as new
    files and entries, none of the files there edited, run."""
    bench = tiny / "perfbench"
    cfg = json.loads((bench / "configs" / "minicpm3-4b.json").read_text())
    cfg["name"] = "newmodel"
    cfg["model"]["num_layers"] = 1
    (bench / "configs" / "newmodel.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "serve-longdoc.json").read_text())
    mix["new_tokens"] = 3
    (bench / "traffic" / "serve-newmix.json").write_text(json.dumps(mix))
    (bench / "metrics" / "batches_seen.serve.py").write_text(
        "def read(ctx):\n    return float(len(ctx.run.batches))\n")
    (bench / "limits" / "newmodel.serve-newmix.json").write_text(
        (bench / "limits" / "minicpm3-4b.serve-longdoc.json").read_text())
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "newmodel", "source": "x",
                            "file": "perfbench/configs/newmodel.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "newmodel.serve-newmix",
                              "config": "newmodel", "traffic":
                              "serve-newmix", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "minicpm3-4b.serve-longdoc" in m.get("workloads", ()):
            m["workloads"].append("newmodel.serve-newmix")
    spec["per_layer"].append({"name": "batches_seen.serve", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "a test", "moves": "ttft_ms.p50",
                              "workloads": ["newmodel.serve-newmix"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))
    line = run_cell(tiny, "newmodel.serve-newmix", trace=1, capsys=capsys)
    assert line["correct"] and line["attempted"] >= 4
    assert line["metrics"]["batches_seen.serve"]["value"] >= 1
    line = run_cell(tiny, "newmodel.serve-newmix", capsys=capsys)
    assert {"ttft_ms.p50", "serve_tokens_per_s", "setup_s"} <= set(
        line["metrics"])


@pytest.mark.parametrize("modules, found", [
    (["repro_torch", "repro_torch.models.transformer", "numpy"], []),
    (["repro_torch", "repro.core.bus"], ["repro"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen", "reprox"], ["flax"]),
])
def test_forbidden_modules_compare_whole_top_level_names(modules, found):
    assert forbidden_modules(modules) == found


def test_a_run_loads_no_jax(tiny):
    """A whole run, in a process of its own, leaves no JAX module and no
    module of the JAX package loaded."""
    code = (
        "import sys, time; from pathlib import Path; "
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]; "
        "from perfbench.harness import cli; "
        "a = cli.parse(['--workload', 'mamba2-2_7b.train-4x2048', "
        "'--seed', '5', '--seconds', '0.2']); "
        f"assert cli.run(a, Path({str(tiny)!r}), time.perf_counter(), "
        "device='cpu') == 0; "
        "print('FOUND', cli.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "FOUND []"


def test_closed_loop_serves_every_seed_the_same_lengths():
    """Prompt lengths come from a stream fixed by the request's place, ids
    from the seed; the warm-up batch is every client at the longest."""
    from perfbench.harness.traffic import generator

    mix = Registry(ROOT).traffic("serve-longdoc")
    lo, hi = mix["prompt_len"]
    a, b = (generator(mix, 1000, seed) for seed in (7, 2**31 + 5))
    for i in range(4):
        pa, pb = a.batch(i), b.batch(i)
        assert [len(p.tokens) for p in pa] == [len(p.tokens) for p in pb]
        assert all(lo <= len(p.tokens) <= hi for p in pa)
        assert any((p.tokens != q.tokens).any() for p, q in zip(pa, pb))
    assert [len(p.tokens) for p in a.warmup()] == [hi] * mix["clients"]
