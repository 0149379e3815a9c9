"""POAS phase 1 — *Predict*.

Builds per-device performance models.  Two sources, both producing the same
``TimeModel`` interface (paper §3.1 stresses modularity of the predictor):

1. ``fit_linear`` — least-squares linear regression of measured time over the
   op count (the paper's approach, §4.1.1).
2. ``Profiler`` — the one-off profiling pass (paper §4.1.2): runs squared
   matmuls of growing size, measures, and regresses.  ``host_cpu_runner``
   times torch matmuls on the host CPU, ``cuda_kernel_runner`` times this
   package's hand-written CUDA GEMM on a card with CUDA events, and
   ``simulated_runner`` reproduces the paper's testbed from device specs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..kernels import matmul
from .device_model import (CopyModel, DeviceProfile, LinearTimeModel,
                           RooflineTimeModel, NO_COPY)

# ---------------------------------------------------------------------------
# Regression
# ---------------------------------------------------------------------------


def fit_linear(ops: Sequence[float], seconds: Sequence[float],
               weights: Sequence[float] | None = None) -> LinearTimeModel:
    """Closed-form (weighted) least squares of t = a*ops + b, a>=0, b>=0."""
    x = np.asarray(ops, dtype=np.float64)
    y = np.asarray(seconds, dtype=np.float64)
    if weights is None:
        w = np.ones_like(x)
    else:
        w = np.asarray(weights, dtype=np.float64)
    sw = w.sum()
    mx, my = (w * x).sum() / sw, (w * y).sum() / sw
    vx = (w * (x - mx) ** 2).sum()
    if vx == 0.0:
        # Degenerate: single size — throughput-only model.  Clamp the slope
        # to the same positive floor as the main path: a zero-slope model
        # ("free compute at any size") would make every downstream solver
        # special-case it (solve_analytic holds zero-slope devices out of
        # the LP; the bisection would hand it the whole workload).
        a = max(float(my / mx) if mx else 0.0, 1e-18)
        return LinearTimeModel(a=a, b=0.0)
    a = float((w * (x - mx) * (y - my)).sum() / vx)
    a = max(a, 1e-18)
    b = max(float(my - a * mx), 0.0)
    return LinearTimeModel(a=a, b=b)


def relative_error(predicted: float, measured: float) -> float:
    """Paper §5.2: e = 100 * (v - v_pred) / v   (reported as |.| percent)."""
    if measured == 0.0:
        return 0.0
    return 100.0 * abs(measured - predicted) / measured


def rmse(errors_pct: Sequence[float]) -> float:
    e = np.asarray(errors_pct, dtype=np.float64)
    return float(np.sqrt(np.mean(e ** 2)))


# ---------------------------------------------------------------------------
# Profiling (paper §4.1.2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ProfileRecord:
    size: int           # squared matmul side
    ops: float          # size**3 MACs
    seconds: float


class Profiler:
    """Runs the paper's profiling pass: squared GEMMs, regress time over ops.

    ``runner(size) -> seconds`` abstracts the backend: real jitted matmul on
    the host, or a simulated device with synthetic noise.
    """

    def __init__(self, runner: Callable[[int], float], *, repeats: int = 5):
        self.runner = runner
        self.repeats = repeats
        self.records: list[ProfileRecord] = []

    def run(self, sizes: Sequence[int]) -> list[ProfileRecord]:
        self.records = []
        for s in sizes:
            ts = [self.runner(s) for _ in range(self.repeats)]
            self.records.append(
                ProfileRecord(size=s, ops=float(s) ** 3,
                              seconds=float(np.mean(ts))))
        return self.records

    def fit(self) -> LinearTimeModel:
        if not self.records:
            raise RuntimeError("run() the profiler before fit()")
        return fit_linear([r.ops for r in self.records],
                          [r.seconds for r in self.records])


def host_cpu_runner(dtype=np.float32) -> Callable[[int], float]:
    """Measure real torch matmul wall time on the host CPU."""

    def run(size: int) -> float:
        key = np.random.default_rng(size)
        a = torch.from_numpy(key.standard_normal((size, size)).astype(dtype))
        b = torch.from_numpy(key.standard_normal((size, size)).astype(dtype))
        torch.matmul(a, b)  # warm the allocator and thread pool
        t0 = time.perf_counter()
        torch.matmul(a, b)
        return time.perf_counter() - t0

    return run


def cuda_kernel_runner(device="cuda",
                       dtype=torch.float32) -> Callable[[int], float]:
    """Time this package's CUDA GEMM kernel on a square size.

    The device-side counterpart of ``host_cpu_runner``: operands are made on
    the card, the kernel runs once to warm up (building it on first use),
    then one launch is timed with CUDA events.  Raises when ``device`` is not
    a CUDA device or no card is present; it never times the CPU instead.
    """
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"cuda_kernel_runner needs a CUDA device, got "
                           f"{device} (cuda available: "
                           f"{torch.cuda.is_available()})")

    def run(size: int) -> float:
        gen = torch.Generator(device=device).manual_seed(size)
        a = torch.randn((size, size), generator=gen, device=device).to(dtype)
        b = torch.randn((size, size), generator=gen, device=device).to(dtype)
        matmul(a, b)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        matmul(a, b)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    return run


def simulated_runner(profile: DeviceProfile, *, noise: float = 0.02,
                     seed: int = 0) -> Callable[[int], float]:
    """Synthesize profiling measurements from a ground-truth device profile.

    Multiplicative Gaussian noise models run-to-run variance (the paper's
    frequency-drift observation, §5.2).
    """
    rng = np.random.default_rng(seed)

    def run(size: int) -> float:
        t = profile.compute(float(size) ** 3)
        return max(t * (1.0 + noise * rng.standard_normal()), 1e-12)

    return run


def measure_bandwidth_simulated(profile: DeviceProfile, *, nbytes: int = 1 << 28,
                                noise: float = 0.01, seed: int = 1) -> float:
    """Paper's memory-bandwidth micro-benchmark, simulated."""
    import math
    if math.isinf(profile.copy.bandwidth_bytes_per_s):
        return float("inf")
    rng = np.random.default_rng(seed)
    t = nbytes / profile.copy.bandwidth_bytes_per_s
    t *= 1.0 + noise * rng.standard_normal()
    return nbytes / max(t, 1e-12)


# ---------------------------------------------------------------------------
# Profile persistence (paper stores profiling results in a text file)
# ---------------------------------------------------------------------------


def save_profiles(path: str, devices: Sequence[DeviceProfile]) -> None:
    import json
    import math
    rows = []
    for d in devices:
        row = {"name": d.name, "kind": d.kind, "align_m": d.align_m,
               "align_k": d.align_k, "cache_bytes": d.cache_bytes,
               "pipeline_chunks": d.pipeline_chunks}
        if isinstance(d.compute, LinearTimeModel):
            row["model"] = {"type": "linear", "a": d.compute.a, "b": d.compute.b}
        else:
            row["model"] = {"type": "roofline",
                            "peak_ops_per_s": d.compute.peak_ops_per_s,
                            "hbm_bytes_per_s": d.compute.hbm_bytes_per_s,
                            "bytes_per_op": d.compute.bytes_per_op,
                            "overhead_s": d.compute.overhead_s}
        row["copy"] = {"bw": (None if math.isinf(d.copy.bandwidth_bytes_per_s)
                              else d.copy.bandwidth_bytes_per_s),
                       "dtype_size": d.copy.dtype_size,
                       "latency_s": d.copy.latency_s}
        rows.append(row)
    with open(path, "w") as f:
        json.dump(rows, f, indent=2)


def load_profiles(path: str) -> list[DeviceProfile]:
    import json
    import math
    with open(path) as f:
        rows = json.load(f)
    out = []
    for row in rows:
        m = row["model"]
        if m["type"] == "linear":
            compute = LinearTimeModel(a=m["a"], b=m["b"])
        else:
            compute = RooflineTimeModel(
                peak_ops_per_s=m["peak_ops_per_s"],
                hbm_bytes_per_s=m["hbm_bytes_per_s"],
                bytes_per_op=m["bytes_per_op"], overhead_s=m["overhead_s"])
        c = row["copy"]
        copy = (NO_COPY if c["bw"] is None else
                CopyModel(c["bw"], dtype_size=c["dtype_size"],
                          latency_s=c["latency_s"]))
        out.append(DeviceProfile(row["name"], row["kind"], compute, copy,
                                 align_m=row["align_m"], align_k=row["align_k"],
                                 cache_bytes=row["cache_bytes"],
                                 pipeline_chunks=row.get("pipeline_chunks", 1)))
    return out
