"""Whole runs of the tiny cells on the CPU: the result line, the check
failing when the timed path is broken underneath, and the control reading
above the program."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT, run_cell

from perfbench.harness import cli, trace

SERVE = ["minicpm3-4b.serve-longdoc"]
TRAIN = ["mamba2-2_7b.train-4x2048"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", SERVE + TRAIN)
@pytest.mark.parametrize("traced", [0, 1])
def test_result_line(tiny, capsys, workload, traced):
    line = run_cell(tiny, workload, trace=traced, capsys=capsys)
    assert list(line) == KEYS + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    kind = "per_layer" if traced else "end_to_end"
    for name, m in line["metrics"].items():
        entry = next(e for e in spec[kind] if e["name"] == name)
        assert m["unit"] == entry["unit"]
        assert m["value"] > 0 or name == "peak_mem_gib"   # no card here
    if not traced:
        assert "setup_s" in line["metrics"]
        assert "peak_mem_gib" in line["metrics"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_traced_line_carries_breakdown():
    t = trace.Trace(ops=[], ranges={}, busy_s=1.5, window_s=2.0,
                    device_ops=[["k", 1.0]], idle_gaps=[["h", 0.5]])
    device = cli.device_block("cpu", 1, 0, t)
    line = cli.result_line(True, 4, 0, {}, device, t, {"x": {}})
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert line["device"]["busy_s"] == 1.5
    assert line["device"]["window_s"] == 2.0


def test_without_a_card_a_run_fails_and_prints_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         "mamba2-2_7b.train-4x2048", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


# faults planted in the timed path: each must turn ``correct`` false


def _unchanged_step(monkeypatch):
    import repro_torch.training as training

    real = training.make_train_step

    def make(model, opt):
        step = real(model, opt)

        def frozen(state, batch):
            saved = {k: p.detach().clone()
                     for k, p in state["params"].items()}
            state, met = step(state, batch)
            for k, p in state["params"].items():
                p.data.copy_(saved[k])
            return state, met
        return frozen
    monkeypatch.setattr(training, "make_train_step", make)


def _half_batch(monkeypatch):
    import repro_torch.training as training

    real = training.make_train_step

    def make(model, opt):
        step = real(model, opt)

        def half(state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half
    monkeypatch.setattr(training, "make_train_step", make)


def _altered_token(monkeypatch):
    from repro_torch.serving import engine

    real = engine.ServingEngine.generate

    def generate(self, requests):
        out = real(self, requests)
        for c in out:
            c.tokens = c.tokens.copy()
            c.tokens[1] = (c.tokens[1] + 97) % 256
        return out
    monkeypatch.setattr(engine.ServingEngine, "generate", generate)


@pytest.mark.parametrize("workload, fault", [
    *[(w, f) for w in TRAIN for f in (_unchanged_step, _half_batch)],
    *[(w, _altered_token) for w in SERVE]],
    ids=lambda x: getattr(x, "__name__", x))
def test_broken_timed_path_is_not_correct(tiny, capsys, monkeypatch,
                                          workload, fault):
    fault(monkeypatch)
    line = run_cell(tiny, workload, capsys=capsys)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("seed", [7, 8, 2**31 + 9])
@pytest.mark.parametrize("workload", TRAIN)
def test_control_reads_above_the_program(tiny, workload, seed):
    """The control (the reference in fp8) reads a gradient gap several
    times the program's (bfloat16) at the tiny size, as it must on the
    chip at the cell's own."""
    from perfbench.harness.registry import Registry

    reg = Registry(tiny)
    cell = reg.workload(workload)
    run = cli.CELLS["synthetic_lm"](reg.config(cell["config"]),
                                    reg.traffic(cell["traffic"]), seed,
                                    "cpu", reg.limits(workload)["check"])
    run.setup()
    n = run.check(precisions=("float32", "fp8"))
    assert n["grad_gap.fp8"] > 3 * n["grad_gap"]


@pytest.mark.card
@pytest.mark.parametrize("workload", SERVE + TRAIN)
def test_each_cell_runs_correct_on_the_card(card, workload):
    """The real command on the card, a short window (run on the chip)."""
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", "2147483913", "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
