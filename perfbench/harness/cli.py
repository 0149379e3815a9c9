"""One run of one cell: set-up, the measured window, on ``--trace 1`` a
traced segment after it, then the check of what the window produced, and
the result as the last line of standard output."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import program
from .registry import Registry
from .serve import ServeCell
from .train import TrainCell

CELLS = {"closed_loop": ServeCell, "synthetic_lm": TrainCell}
# top-level modules that may not be loaded in a run: JAX, and the JAX
# package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = 1 << 30


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules(modules=None) -> list[str]:
    """The top-level names (before the first dot, compared whole) of the
    loaded modules that a run may not hold."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


class Context:
    """What a per-layer metric's ``read(ctx)`` sees: the cell, its
    configuration and mix, the window's records (``ctx.run``, a
    ``ServeCell`` or ``TrainCell``), the trace or None, and the peaks."""

    def __init__(self, workload, config, mix, run, trace, peaks):
        self.workload, self.config, self.mix = workload, config, mix
        self.run, self.trace, self.peaks = run, trace, peaks


def device_block(device, count: int, peak: int, trace) -> dict:
    if torch.device(device).type == "cuda":
        block = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                 "count": count, "memory_peak_bytes": peak}
    else:
        block = {"platform": "cpu", "kind": "cpu", "count": count,
                 "memory_peak_bytes": peak}
    if trace is not None:
        block.update(busy_s=trace.busy_s, window_s=trace.window_s)
    return block


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, trace, checks: dict) -> dict:
    """The result: the keys the contract names, ``breakdown`` when traced,
    and last the numbers ``correct`` compared, each beside its limit."""
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.device_ops,
                               "idle_gaps": trace.idle_gaps}
    result["checks"] = checks
    return result


def run(args, root: Path, started: float, device=None) -> int:
    """One run; ``device`` None looks for the cell's cards (and fails
    without them), a device given (the tests: "cpu") skips the look."""
    reg = Registry(root)
    cell = reg.workload(args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
                  f"torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}", file=sys.stderr)
            return 2
        device = "cuda"
    on_card = torch.device(device).type == "cuda"
    cfg, mix = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    limits = reg.limits(cell["name"])
    cellrun = CELLS[mix["kind"]](cfg, mix, args.seed, device,
                                  limits["check"])
    t_setup = time.perf_counter()
    cellrun.setup()
    setup_s = time.perf_counter() - started
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    program.reset_launch_counts()
    cellrun.window(args.seconds)
    launches = program.launch_counts()
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    peak = max(setup_peak, window_peak)
    t_window = time.perf_counter()
    trace = cellrun.traced_segment() if args.trace else None
    t_trace = time.perf_counter()
    attempted, failed = cellrun.requests()
    e2e = dict(cellrun.end_to_end(), peak_mem_gib=window_peak / GIB,
               setup_s=setup_s)
    numbers = cellrun.check()
    print(f"set-up: {t_setup - started:.1f} s to import and find the "
          f"cell, then " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                     cellrun.phases.items()),
          file=sys.stderr)
    print(f"kernel launches in the window: {launches}", file=sys.stderr)
    print("window: ends of its batches or steps (s) "
          + " ".join(f"{t:.3f}" for t in cellrun.marks()), file=sys.stderr)
    print(f"setup {setup_s:.1f} s, window {t_window - started - setup_s:.1f}"
          f" s, trace {t_trace - t_window:.1f} s, check "
          f"{time.perf_counter() - t_trace:.1f} s", file=sys.stderr)
    peaks = json.loads((reg.bench / "costs" / "peaks.json").read_text())
    ctx = Context(cell, cfg, mix, cellrun, trace, peaks)
    metrics = {}
    for m in reg.metrics(cell["name"], bool(args.trace)):
        value = (reg.reader(m["name"])(ctx) if args.trace
                 else e2e.get(m["name"]))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": numbers[k], "limit": v["limit"]}
              for k, v in limits["numbers"].items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    bad = forbidden_modules()
    if bad:
        print(f"a run may not load {bad}; it did", file=sys.stderr)
        return 3
    result = result_line(correct, attempted, failed, metrics,
                         device_block(device, cell["chips"], peak, trace),
                         trace, checks)
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
