"""Device performance models — the substrate of the POAS *Predict* phase.

The paper models each device's GEMM execution time as a *linear* function of
the operation count ``ops = m*n*k`` (paper §4.1.1), plus a bandwidth-based
copy-time model (paper Eq. 4).  We keep exactly that structure, generalized so
the same machinery drives the paper's CPU/GPU/XPU case study and the
reference's planning model of a TPU device group (``tpu_group``), which is
kept so that plans made with it match the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

# ---------------------------------------------------------------------------
# Time models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinearTimeModel:
    """t(ops) = a*ops + b   (seconds).  Paper §4.2.1: ``t_cx = a*c_x + b``."""

    a: float  # seconds per op (one op = one multiply-accumulate)
    b: float = 0.0  # fixed overhead in seconds

    def __call__(self, ops: float) -> float:
        return self.a * float(ops) + self.b

    def inverse(self, t: float) -> float:
        """Largest op count finishing within time ``t`` (0 if none)."""
        if t <= self.b:
            return 0.0
        return (t - self.b) / self.a


@dataclasses.dataclass(frozen=True)
class RooflineTimeModel:
    """TPU-native predictor: t = max(flops/peak, bytes/bw) + overhead.

    Used when a device group's cost comes from XLA ``cost_analysis`` rather
    than profiled regression.  ``bytes_per_op`` converts an op count into HBM
    traffic so the same ``ops``-denominated interface works.
    """

    peak_ops_per_s: float  # MAC ops/s (peak_flops/2)
    hbm_bytes_per_s: float
    bytes_per_op: float = 0.0
    overhead_s: float = 0.0

    def __call__(self, ops: float) -> float:
        ops = float(ops)
        t_compute = ops / self.peak_ops_per_s
        t_memory = ops * self.bytes_per_op / self.hbm_bytes_per_s
        return max(t_compute, t_memory) + self.overhead_s

    def inverse(self, t: float) -> float:
        if t <= self.overhead_s:
            return 0.0
        sec_per_op = max(
            1.0 / self.peak_ops_per_s,
            self.bytes_per_op / self.hbm_bytes_per_s,
        )
        return (t - self.overhead_s) / sec_per_op


TimeModel = LinearTimeModel | RooflineTimeModel


# ---------------------------------------------------------------------------
# Copy model (paper Eq. 4)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CopyModel:
    """Host<->device transfer time for a GEMM slice.

    Paper Eq. 4:  y_x = (dt_x * (c_x*(1/k + 1/n) + k*n)) / bw_x

    A device computing ``c`` ops of an (m,n,k) GEMM holds an A slice of
    ``c/n`` elements (m_x*k), the full B (k*n elements) and produces a C slice
    of ``c/k`` elements (m_x*n).  (We multiply the ``k*n`` term by the dtype
    size as well; the paper's rendering omits it, which is dimensionally
    inconsistent and clearly a typo.)
    """

    bandwidth_bytes_per_s: float
    dtype_size: int = 4
    latency_s: float = 0.0  # paper neglects latency; kept for completeness

    def in_bytes(self, c: float, n: int, k: int) -> float:
        """Bytes moved host->device (A slice + full B)."""
        return self.dtype_size * (c / n + float(k) * n)

    def out_bytes(self, c: float, n: int, k: int) -> float:
        """Bytes moved device->host (C slice)."""
        return self.dtype_size * (c / k)

    def total_bytes(self, c: float, n: int, k: int) -> float:
        return self.in_bytes(c, n, k) + self.out_bytes(c, n, k)

    def __call__(self, c: float, n: int, k: int) -> float:
        if math.isinf(self.bandwidth_bytes_per_s):
            return 0.0
        return self.total_bytes(c, n, k) / self.bandwidth_bytes_per_s + self.latency_s

    def in_time(self, c: float, n: int, k: int) -> float:
        if math.isinf(self.bandwidth_bytes_per_s):
            return 0.0
        return self.in_bytes(c, n, k) / self.bandwidth_bytes_per_s + self.latency_s

    def out_time(self, c: float, n: int, k: int) -> float:
        if math.isinf(self.bandwidth_bytes_per_s):
            return 0.0
        return self.out_bytes(c, n, k) / self.bandwidth_bytes_per_s


NO_COPY = CopyModel(bandwidth_bytes_per_s=math.inf, dtype_size=0)


# ---------------------------------------------------------------------------
# Device profile
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Everything POAS needs to know about one schedulable compute element.

    For the paper's case study a "device" is a CPU / GPU / XPU; for the
    distributed runtime it is a TPU pod-slice (device group).
    """

    name: str
    kind: str  # "cpu" | "gpu" | "xpu" | "tpu-group"
    compute: TimeModel
    copy: CopyModel = NO_COPY
    # Hardware adjustment constraints (paper §4.3.2):
    align_m: int = 1  # row-count granularity (tensor cores: 8; MXU: 8*128 grain)
    align_k: int = 1
    cache_bytes: float = math.inf  # CPU LLC / TPU VMEM working-set bound
    # Chunked pipelined copies (core.bus): split the input copy into C
    # chunks so compute on chunk 1 overlaps the transfer of chunk 2.  The
    # GEMM adapt phase maps this to row-chunks; 1 = unpipelined (paper).
    pipeline_chunks: int = 1
    # Power model (POAS §6 names energy-aware scheduling as future work;
    # Hill & Reddi's ALP viewpoint makes joules half the pitch).  A device
    # burns ``idle_watts`` whenever the schedule holds it idle and
    # ``joules_per_op`` for every MAC it executes; both default to 0 so
    # pre-power profiles (and pure-makespan solves) are unchanged.
    idle_watts: float = 0.0
    joules_per_op: float = 0.0

    def total_time(self, c: float, n: int, k: int) -> float:
        """Compute + (non-serialized) copy time for ``c`` ops — paper Eq. 1 term."""
        return self.compute(c) + self.copy(c, n, k)

    def with_power(self, idle_watts: float,
                   joules_per_op: float) -> "DeviceProfile":
        return dataclasses.replace(self, idle_watts=idle_watts,
                                   joules_per_op=joules_per_op)

    @property
    def effective_speed(self) -> float:
        """ops/s ignoring copies — used for priority ordering (paper §4.4)."""
        t1 = self.compute(1e12) - self.compute(0.0)
        return 1e12 / t1 if t1 > 0 else math.inf


def priority_order(devices: Sequence[DeviceProfile]) -> list[int]:
    """Paper §4.4: the faster the device, the higher the bus priority."""
    return sorted(range(len(devices)), key=lambda i: -devices[i].effective_speed)


def with_pipeline(devices: Sequence[DeviceProfile],
                  chunks: int) -> list[DeviceProfile]:
    """Copies of ``devices`` with ``pipeline_chunks`` set on every device
    that actually copies (no-copy devices gain nothing from chunking and
    would only pay the per-chunk launch overhead)."""
    return [dataclasses.replace(d, pipeline_chunks=max(1, int(chunks)))
            if not math.isinf(d.copy.bandwidth_bytes_per_s) else d
            for d in devices]


# ---------------------------------------------------------------------------
# Reference profiles
# ---------------------------------------------------------------------------

def _linear_from_tflops(eff_tflops: float, overhead_s: float = 1e-4) -> LinearTimeModel:
    """Effective sustained TFLOP/s -> seconds-per-MAC linear model.

    One op (MAC) = 2 FLOPs.
    """
    ops_per_s = eff_tflops * 1e12 / 2.0
    return LinearTimeModel(a=1.0 / ops_per_s, b=overhead_s)


def paper_mach1() -> list[DeviceProfile]:
    """Simulated profiles for the paper's mach1 (Xeon E5-2603v3 + 2×2080 Ti).

    Effective (not peak) throughputs calibrated so the optimized work split
    reproduces the paper's Table 6 (~0.3 % CPU / ~22 % GPU / ~78 % XPU) and
    Table 7 speedups (1.14–1.28× vs XPU alone).
    """
    pcie3 = 15.75e9
    return [
        DeviceProfile("xeon-e5", "cpu", _linear_from_tflops(0.28), NO_COPY,
                      align_m=1, cache_bytes=15e6),
        DeviceProfile("2080ti-cuda", "gpu", _linear_from_tflops(12.5),
                      CopyModel(pcie3, dtype_size=4)),
        DeviceProfile("2080ti-tensor", "xpu", _linear_from_tflops(48.0),
                      CopyModel(pcie3, dtype_size=2), align_m=8, align_k=8),
    ]


def paper_mach2() -> list[DeviceProfile]:
    """Simulated profiles for the paper's mach2 (EPYC 7413 + 3090 + 2080 Ti).

    Note the paper's quirk: on mach2 the *GPU* is the 3090 (PCIe 4.0,
    31.5 GB/s) while the *XPU* is the 2080 Ti's tensor cores (PCIe 3.0).
    """
    pcie3, pcie4 = 15.75e9, 31.5e9
    return [
        DeviceProfile("epyc-7413", "cpu", _linear_from_tflops(2.4), NO_COPY,
                      align_m=1, cache_bytes=128e6),
        DeviceProfile("3090-cuda", "gpu", _linear_from_tflops(30.0),
                      CopyModel(pcie4, dtype_size=4)),
        DeviceProfile("2080ti-tensor", "xpu", _linear_from_tflops(75.0),
                      CopyModel(pcie3, dtype_size=2), align_m=8, align_k=8),
    ]


# The reference's planning model of one TPU chip, copied as it stands so
# that a plan over ``tpu_group`` profiles is the reference's plan, byte for
# byte.  These are inputs to planning, not measurements of any device this
# package runs on.
TPU_PEAK_FLOPS = 197e12
TPU_HBM_BW = 819e9
TPU_ICI_BW = 50e9
TPU_VMEM_BYTES = 128 * 1024 * 1024


def tpu_group(name: str, chips: int, *, derate: float = 1.0,
              feed_bw: float = TPU_ICI_BW,
              overhead_s: float = 5e-5) -> DeviceProfile:
    """A pod-slice of ``chips`` TPU chips as one schedulable POAS device.

    ``derate`` < 1 models stragglers / older generations / thermal throttle.
    """
    peak_ops = chips * TPU_PEAK_FLOPS * derate / 2.0
    return DeviceProfile(
        name, "tpu-group",
        RooflineTimeModel(peak_ops_per_s=peak_ops,
                          hbm_bytes_per_s=chips * TPU_HBM_BW * derate,
                          bytes_per_op=0.0, overhead_s=overhead_s),
        CopyModel(feed_bw * chips, dtype_size=2),
        align_m=8, align_k=128,
        cache_bytes=TPU_VMEM_BYTES,
    )
