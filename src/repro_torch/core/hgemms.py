"""hgemms — the paper's DS-POAS for heterogeneous GEMM (§4).

Splits an (m, n, k) GEMM's rows across heterogeneous devices per the POAS
plan and executes the partitions through the overlapped co-execution runtime
(``core.executor``): one thread per device, input/output copies serialized
on the shared bus in the planned priority order, compute overlapping other
devices' copies.

Placement: a profile of kind ``"cpu"`` computes its partition on the host
with ``torch.matmul``.  Every other profile (``gpu``, ``xpu``) computes on
``device`` through the hand-written CUDA GEMM (``kernels.matmul``), each on
its own pair of CUDA streams (copies, compute), so the paper's two
accelerators of one machine become two stream pairs on one card.  Copies are real host<->device transfers and every
stage synchronises its stream before it returns, so the executor's measured
timeline holds real intervals.  With ``device="cpu"`` the non-CPU partitions
run the kernel's plain version on host tensors instead.

Per-device *times* in the report still come from the device models, exactly
as in the reference, so plans and simulated makespans compare byte for byte.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from ..kernels import matmul
from .adapt import GemmPlan
from .bus import BusTopology
from .device_model import DeviceProfile, with_pipeline
from .domain import PlanCache
from .executor import DeviceTask, OverlappedExecutor
from .framework import GemmWorkload, POASPlan, make_gemm_poas
from .schedule import DynamicScheduler, Timeline, simulate_timeline


@dataclasses.dataclass
class ExecutionReport:
    plan: POASPlan
    timeline: Timeline
    predicted_makespan: float
    simulated_makespan: float      # from device models (+noise if asked)
    wall_seconds: float            # actual host wall time of the partitions
    standalone: dict[str, float]   # predicted time if each device ran alone
    per_device_seconds: dict[str, float]
    measured: Timeline | None = None   # executor's real per-stage intervals

    @property
    def speedups(self) -> dict[str, float]:
        return {name: t / self.simulated_makespan
                for name, t in self.standalone.items()}


class _Lane:
    """Where one device's partition runs.

    A ``"cpu"`` profile — and every profile when ``HGemms`` runs on the
    CPU — is a host lane: tensors are numpy views, nothing is copied.  Any
    other profile on a CUDA ``device`` is a card lane with its own pair of
    streams, one for copies and one for compute, so a pipelined device's
    copy of chunk j+1 overlaps its product of chunk j.  Each stage runs on
    its stream and waits for it before returning, so the executor's
    measured interval is the device's real work.
    """

    def __init__(self, kind: str, device: torch.device):
        on_card = kind != "cpu" and device.type == "cuda"
        self.target = torch.device("cpu") if kind == "cpu" else device
        self.mm = torch.matmul if kind == "cpu" else matmul
        self.copy_stream = torch.cuda.Stream(device) if on_card else None
        self.compute_stream = torch.cuda.Stream(device) if on_card else None

    @staticmethod
    @contextlib.contextmanager
    def _on(stream):
        if stream is None:
            yield
            return
        with torch.cuda.stream(stream):
            yield
        stream.synchronize()

    def copy_in(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """Host -> device; pageable sources, so the copy is staged."""
        with self._on(self.copy_stream):
            return [torch.from_numpy(x).to(self.target, non_blocking=True)
                    for x in arrays]

    def compute(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with self._on(self.compute_stream):
            if self.compute_stream is not None:   # made on the copy stream
                x.record_stream(self.compute_stream)
                y.record_stream(self.compute_stream)
            return self.mm(x, y)

    def copy_out(self, dst: np.ndarray, src: torch.Tensor) -> None:
        """Device -> host, into ``dst`` (a row slice of C) in place."""
        with self._on(self.copy_stream):
            if self.copy_stream is not None:      # made on the compute stream
                src.record_stream(self.copy_stream)
            torch.from_numpy(dst).copy_(src, non_blocking=True)


class HGemms:
    """Heterogeneous GEMM scheduler (paper §4), executing on ``device``.

    ``device`` defaults to the card; it raises when CUDA is asked for and
    no card is present, and never carries on on the CPU.  Pass
    ``device="cpu"`` to run every partition on the host.
    """

    def __init__(self, devices: Sequence[DeviceProfile], *,
                 device: str | torch.device = "cuda",
                 bus: str | BusTopology = "serialized",
                 dynamic: bool = False, cache: bool = True,
                 pipeline_chunks: int | None = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"HGemms: device={self.device} but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run on the host")
        self.devices = list(devices)
        if pipeline_chunks is not None:
            # chunked pipelined copies (DESIGN.md §4): the adapt phase maps
            # each copying device's chunk count to row-chunks of its A slice
            self.devices = with_pipeline(self.devices, pipeline_chunks)
        self.poas, self.dyn = make_gemm_poas(self.devices, bus=bus,
                                             dynamic=dynamic, cache=cache)
        self.bus = self.poas.domain.bus
        self.topology = self.poas.domain.topology
        self.lanes = {d.name: _Lane(d.kind, self.device)
                      for d in self.devices}

    @property
    def plan_cache(self) -> PlanCache | None:
        return self.poas.cache

    # -- planning ----------------------------------------------------------

    def plan(self, m: int, n: int, k: int) -> POASPlan:
        return self.poas.plan(GemmWorkload(m=m, n=n, k=k))

    # -- execution ---------------------------------------------------------

    def _partition_tasks(self, a: np.ndarray, b: np.ndarray, c: np.ndarray,
                         gplan: GemmPlan, planned: Timeline) -> list[DeviceTask]:
        """One ``DeviceTask`` per device with work; stages mirror the planned
        timeline (devices with no planned copy event compute in place).
        Devices with pipelined row chunks get per-chunk stage lists so the
        executor streams them — chunk 1's matmul really overlaps chunk 2's
        copy, the overlap the chunked plan prices."""
        planned_kinds = {(e.device, e.kind) for e in planned.events}
        tasks: list[DeviceTask] = []
        for dev, asg in zip(self.devices, gplan.assignments):
            if asg.m == 0:
                continue
            lane = self.lanes[dev.name]
            has_in = (dev.name, "copy_in") in planned_kinds
            has_out = (dev.name, "copy_out") in planned_kinds
            state: dict = {}
            if has_in and len(asg.chunk_rows) > 1:
                tasks.append(self._pipelined_task(
                    lane, a, b, c, dev.name, asg, has_out, state))
                continue
            rows = slice(asg.row0, asg.row0 + asg.m)

            def copy_in(state=state, rows=rows, lane=lane):
                # host -> device: A row-slice + full B
                state["a"], state["b"] = lane.copy_in(a[rows], b)

            def compute(state=state, rows=rows, lane=lane):
                if "a" not in state:      # no-copy device computes in place
                    state["a"], state["b"] = lane.copy_in(a[rows], b)
                state["c"] = lane.compute(state["a"], state["b"])

            def copy_out(state=state, rows=rows, lane=lane):
                lane.copy_out(c[rows], state["c"])

            if not has_out:
                # fold the C write into compute so the result still lands
                def compute(state=state, rows=rows, inner=compute, lane=lane):
                    inner()
                    lane.copy_out(c[rows], state["c"])
            tasks.append(DeviceTask(
                device=dev.name,
                copy_in=copy_in if has_in else None,
                compute=compute,
                copy_out=copy_out if has_out else None))
        return tasks

    @staticmethod
    def _pipelined_task(lane: _Lane, a: np.ndarray, b: np.ndarray,
                        c: np.ndarray, device: str, asg, has_out: bool,
                        state: dict) -> DeviceTask:
        """Per-chunk stage lists from the adapt phase's ``chunk_rows``: the
        shared B panel rides input chunk 0 (exactly how the engine prices
        it), chunk j's matmul consumes its own A slice, chunk j's C slice
        lands in the output stage (or inside compute for no-copy-out)."""
        in_chunks, comp_chunks, out_chunks = [], [], []
        for j, (r0, rr) in enumerate(zip(asg.chunk_offsets(),
                                         asg.chunk_rows)):
            def copy_in(j=j, r0=r0, rr=rr, state=state):
                if j == 0:
                    state["b"], = lane.copy_in(b)
                state["a", j], = lane.copy_in(a[r0:r0 + rr])

            def compute(j=j, r0=r0, rr=rr, state=state):
                state["c", j] = lane.compute(state["a", j], state["b"])
                if not has_out:
                    lane.copy_out(c[r0:r0 + rr], state["c", j])

            def copy_out(j=j, r0=r0, rr=rr, state=state):
                lane.copy_out(c[r0:r0 + rr], state["c", j])

            in_chunks.append(copy_in)
            comp_chunks.append(compute)
            out_chunks.append(copy_out)
        return DeviceTask(
            device=device, copy_in=None, compute=None, copy_out=None,
            copy_in_chunks=in_chunks, compute_chunks=comp_chunks,
            copy_out_chunks=out_chunks if has_out else None)

    def execute(self, a: np.ndarray, b: np.ndarray, *,
                noise: float = 0.0, seed: int = 0,
                plan: POASPlan | None = None) -> tuple[np.ndarray, ExecutionReport]:
        """Run the co-executed GEMM.  Returns (C, report).

        Partitions run concurrently through ``OverlappedExecutor`` (real
        numerics, real copies and overlap, bus order from the plan); the
        report's ``measured`` timeline holds the real stage intervals, while
        the per-device model *times* (optionally noised) are computed as in
        the reference, so simulated makespans compare exactly.
        """
        a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
        m, k = a.shape
        k2, n = b.shape
        assert k == k2, (a.shape, b.shape)
        p = plan or self.plan(m, n, k)
        gplan: GemmPlan = p.adapted

        rng = np.random.default_rng(seed)
        c = np.zeros((m, n), dtype=np.result_type(a.dtype, b.dtype))
        planned = p.schedule.timeline
        tasks = self._partition_tasks(a, b, c, gplan, planned)

        t0 = time.perf_counter()
        measured = OverlappedExecutor(self.devices, planned).run(tasks)
        wall = time.perf_counter() - t0

        device_times: dict[str, float] = {}
        ops_list = []
        for di, (dev, asg) in enumerate(zip(self.devices, gplan.assignments)):
            ops_list.append(asg.ops)
            if asg.m == 0:
                device_times[dev.name] = 0.0
                continue
            t = dev.total_time(asg.ops, n, k)
            if noise:
                t *= 1.0 + noise * rng.standard_normal()
            device_times[dev.name] = t
            if self.dyn is not None:
                self.dyn.observe(di, asg.ops,
                                 dev.compute(asg.ops) * (1.0 + (noise * rng.standard_normal() if noise else 0.0)))
        tl = simulate_timeline(self.devices, ops_list, n, k,
                               topology=self.topology,
                               chunks=[max(1, len(a.chunk_rows))
                                       for a in gplan.assignments])
        standalone = {d.name: d.total_time(float(m) * n * k, n, k)
                      for d in self.devices}
        rep = ExecutionReport(
            plan=p, timeline=tl,
            predicted_makespan=p.schedule.timeline.makespan,
            simulated_makespan=max(tl.makespan,
                                   max(device_times.values(), default=0.0)),
            wall_seconds=wall, standalone=standalone,
            per_device_seconds=device_times,
            measured=measured)
        return c, rep

    # -- prediction accuracy experiment (paper §5.2) ------------------------

    def prediction_errors(self, m: int, n: int, k: int, *,
                          noise: float = 0.03, seed: int = 0) -> dict[str, dict[str, float]]:
        """Per-device compute/copy/global relative error vs a noisy 'measured'
        run — reproduces Table 4's structure on the simulated testbed."""
        from .predict import relative_error
        p = self.plan(m, n, k)
        gplan: GemmPlan = p.adapted
        rng = np.random.default_rng(seed)
        out: dict[str, dict[str, float]] = {}
        for dev, asg in zip(self.devices, gplan.assignments):
            if asg.m == 0:
                continue
            pred_c = dev.compute(asg.ops)
            pred_y = dev.copy(asg.ops, n, k)
            meas_c = pred_c * (1.0 + noise * rng.standard_normal())
            meas_y = pred_y * (1.0 + 0.3 * noise * rng.standard_normal())
            out[dev.name] = {
                "compute": relative_error(pred_c, meas_c),
                "copy": relative_error(pred_y, meas_y) if pred_y else 0.0,
                "global": relative_error(pred_c + pred_y, meas_c + meas_y),
            }
        return out
