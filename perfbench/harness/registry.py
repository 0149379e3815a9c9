"""Finds what ``BENCHMARK.json`` names, by name, as files of their own:

* ``configs/<config>.json``: a configuration, as it is run;
* ``traffic/<mix>.json``: a traffic mix, the parameters of one of the
  general generators in ``harness/traffic.py`` (its ``kind``);
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``;
* ``limits/<workload>.json``: the limits of a cell's ``correct``.

A later change adds a configuration, a mix, a metric or a cell by adding
such files and entries, and edits none that is there.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class Registry:
    def __init__(self, root: Path):
        """``root``: the checkout, holding ``BENCHMARK.json``; the
        benchmark's files lie under ``root / "perfbench"``."""
        self.root = Path(root)
        self.bench = self.root / "perfbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.bench / "limits" / f"{workload}.json")
                          .read_text())

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The metrics a run of ``workload`` reports: its end-to-end ones,
        or with ``trace`` its per-layer ones."""
        out = []
        for m in self.spec["per_layer" if trace else "end_to_end"]:
            cells = m.get("workloads")
            if cells is None or workload in cells:
                out.append(m)
        return out

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``metrics/<metric>.py``."""
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
