#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port on one NVIDIA H100, end to end.

    python3 chip_smoke.py

Phases, each printing its own lines (no phase catches its own failure; any
failed check exits non-zero):

1. env     — card name and power limit, torch/CUDA/nvcc versions.
2. build   — compile the hand-written CUDA kernels from the checkout.
3. kernel  — every kernel against its plain PyTorch version on the card, at
             test shapes and at the main path's shapes, with times beside
             the card's bound and a PyTorch library call.
4. predict — fit the node (host CPU + card) with ``Profiler``/``fit_linear``
             and a timed host->device copy; no rate is hard-coded.
5. main    — ``HGemms(fitted, device="cuda").execute`` on the paper's
             instance i1 (30000^3, float32): kernel launches counted, the bus
             invariants of the measured timeline held, sampled rows of C
             checked against float64, then the card alone for comparison.

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or run outside the
repository (the import of ``repro_torch`` fails), it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import (CopyModel, DeviceProfile, HGemms,  # noqa: E402
                              NO_COPY, Profiler, cuda_kernel_runner,
                              host_cpu_runner)
from repro_torch.kernels import matmul  # noqa: E402
from repro_torch.kernels.matmul import build  # noqa: E402
from repro_torch.kernels.ref import matmul_ref  # noqa: E402

# Paper instance i1 (benchmarks/common.py): the smallest of the six.
M = N = K = 30_000
SAMPLE_ROWS = 64
F32_TOL = (1e-4, 1e-3)    # rtol, atol: tests/test_kernels_matmul.py:34
BF16_TOL = (2e-2, 2e-1)
# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
PEAK = {"float32": (67e12, "67 TFLOP/s fp32 CUDA cores, H100 SXM data sheet"),
        "bfloat16": (989e12, "989 TFLOP/s bf16 dense tensor cores, "
                             "H100 SXM data sheet")}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn) -> float:
    """Mean device time of ``fn`` in ms: one warm call, then enough calls
    between two CUDA events to span ~0.2 s."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(1, min(50, int(0.2 / max(time.perf_counter() - t0, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(m: int, k: int, n: int, dtype: str) -> tuple[float, str]:
    """Least time for C = A @ B on this card: the larger of the operations
    over the type's peak and the bytes (A, B read once, C written once)
    over the memory rate."""
    size = 4 if dtype == "float32" else 2
    t_ops = 2.0 * m * n * k / PEAK[dtype][0]
    t_bytes = size * (m * k + k * n + m * n) / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def compare(a, b, dtype: str, tol, label: str, exact_rows=None) -> dict:
    """Kernel vs plain version on the same card tensors, then both timed
    beside one library call.  ``exact_rows``: also hold the kernel against
    float64 on those rows, at the unscaled tolerance."""
    m, k = a.shape
    n = b.shape[1]
    rtol, atol = tol
    if dtype == "float32" and k > 4096:
        # The plain version is itself a float32 product: its rounding grows
        # with K (worst case linearly), and the gate was set at K <= 4096.
        atol = tol[1] * k / 4096
    out = matmul(a, b)
    torch.cuda.synchronize()
    plain = matmul_ref(a, b)
    torch.cuda.synchronize()
    diff = (out.float() - plain.float()).abs()
    err = float(diff.max())
    bad = int((diff > atol + rtol * plain.float().abs()).sum())
    row = {"shape": [m, k, n], "dtype": dtype, "max_abs_err": err,
           "violations": bad, "rtol": rtol, "atol": atol}
    say("kernel", f"{label} {m}x{k}x{n} {dtype}: vs plain max_abs_err="
        f"{err:.3e} violations={bad} (rtol {rtol}, atol {atol:.3g})")
    if exact_rows is not None:
        exact = a[exact_rows].double() @ b.double()
        k_err = (out[exact_rows].double() - exact).abs()
        p_err = float((plain[exact_rows].double() - exact).abs().max())
        row["violations"] += int((k_err > tol[1] + tol[0] * exact.abs())
                                 .sum())
        say("kernel", f"{label}: {len(exact_rows)} rows vs float64: kernel "
            f"max_abs_err={float(k_err.max()):.3e} (rtol {tol[0]}, atol "
            f"{tol[1]}), plain version {p_err:.3e}")
        del exact, k_err
    del out, plain, diff
    row["kernel_ms"] = cuda_ms(lambda: matmul(a, b))
    row["plain_ms"] = cuda_ms(lambda: matmul_ref(a, b))
    row["library_ms"] = cuda_ms(lambda: torch.matmul(a, b))
    row["bound_ms"], row["bound_by"] = bound_ms(m, k, n, dtype)
    say("kernel", f"{label} {m}x{k}x{n} {dtype}: kernel_ms="
        f"{row['kernel_ms']:.4f} plain_ms={row['plain_ms']:.4f} library_ms="
        f"{row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
        f"({row['bound_by']}; {PEAK[dtype][1]}; "
        f"{HBM_BYTES_PER_S / 1e12} TB/s HBM, H100 SXM data sheet)")
    return row


def bus_invariants(measured, planned) -> None:
    """The reference's invariants on a measured timeline
    (tests/test_bus_timeline.py): per-link transfers never overlap, each
    link grants in the plan's ticket order, and every compute starts after
    its own input copy."""
    for link, seq in planned.link_ticket_order().items():
        evs = measured.link_events(link)
        for x, y in zip(evs, evs[1:]):
            check(y.start >= x.end - 1e-9, f"transfers overlap on {link}: "
                  f"{x} / {y}")
        got = []
        for e in sorted(evs, key=lambda e: e.start):
            if (e.device, e.kind) not in got:
                got.append((e.device, e.kind))
        check(got == seq, f"link {link} order {got} != plan {seq}")
    for name in {e.device for e in measured.events}:
        evs = measured.device_events(name)
        ins = sorted((e for e in evs if e.kind == "copy_in"),
                     key=lambda e: e.chunk)
        comps = sorted((e for e in evs if e.kind == "compute"),
                       key=lambda e: e.chunk)
        for i_ev, c_ev in zip(ins, comps):
            check(c_ev.start >= i_ev.end - 1e-9,
                  f"{name} computed before its input landed")


def check_rows(c, a, b, rows, label: str) -> float:
    """Sampled rows of C against float64 numpy."""
    want = a[rows].astype(np.float64) @ b
    got = c[rows].astype(np.float64)
    err = float(np.max(np.abs(got - want)))
    ok = np.allclose(got, want, rtol=F32_TOL[0], atol=F32_TOL[1])
    say("main", f"{label}: {len(rows)} sampled rows vs float64: "
        f"max_abs_err={err:.3e} allclose(rtol {F32_TOL[0]}, atol "
        f"{F32_TOL[1]})={ok}")
    check(bool(np.isfinite(c).all()), f"{label}: C is not finite")
    check(ok, f"{label}: sampled rows of C disagree with float64 A@B")
    return err


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # library yardstick: fp32
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. env ----------------------------------------------------------
    card = smi()
    print(card, flush=True)
    nvcc = subprocess.run(["bash", "-c", "nvcc --version 2>/dev/null || "
                           "/usr/local/cuda/bin/nvcc --version"],
                          capture_output=True, text=True).stdout
    cap = torch.cuda.get_device_capability(0)
    say("env", f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, nvcc "
        f"{(nvcc.strip().splitlines() or ['?'])[-1]}; capability {cap} "
        f"(9, 0): {cap == (9, 0)}; python {sys.version.split()[0]}")

    # ---- 2. build --------------------------------------------------------
    info = build()
    say("build", f"{info.path.relative_to(ROOT)} in {info.seconds:.1f} s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say("build", line.strip())

    # ---- 3. kernel vs plain version (test shapes) ------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows_out = []
    for dtype_name, dtype, tol in (("float32", torch.float32, F32_TOL),
                                   ("bfloat16", torch.bfloat16, BF16_TOL)):
        for m, k, n in ((128, 128, 128), (100, 130, 50), (8, 128, 128),
                        (4096, 4096, 4096)):
            rows_out.append(compare(randn(m, k, dtype=dtype),
                                    randn(k, n, dtype=dtype),
                                    dtype_name, tol, "test"))
    # 64-bit offsets: A holds more than 2**31 elements (as A of i3-i6 does);
    # the float64 rows are the last ones, past the 32-bit range.
    big_a = randn(70_000, 32_000, dtype=torch.float32)
    rows_out.append(compare(big_a, randn(32_000, 64, dtype=torch.float32),
                            "float32", F32_TOL, "int64-offsets",
                            exact_rows=torch.arange(69_936, 70_000,
                                                    device=dev)))
    del big_a
    acc_a = torch.full((8, 4096), 0.01, dtype=torch.bfloat16, device=dev)
    acc_b = torch.full((4096, 128), 0.01, dtype=torch.bfloat16, device=dev)
    rows_out.append(compare(acc_a, acc_b, "bfloat16", BF16_TOL,
                            "bf16-accumulation"))
    got = float(matmul(acc_a, acc_b)[0, 0])
    want = 4096 * 0.01 * 0.01
    say("kernel", f"bf16 k=4096 accumulation: {got:.5f} vs {want:.5f} "
        f"(rel {abs(got - want) / want:.2e} < 0.02)")
    check(abs(got - want) / want < 0.02, "bf16 inputs do not accumulate in f32")
    for r in rows_out:
        check(r["violations"] == 0, f"kernel disagrees with plain version: {r}")

    # ---- 4. predict: fit the node ----------------------------------------
    t0 = time.perf_counter()
    cpu_prof = Profiler(host_cpu_runner(np.float32), repeats=3)
    cpu_prof.run(range(1000, 2001, 100))
    cpu_fit = cpu_prof.fit()
    gpu_prof = Profiler(cuda_kernel_runner(dev, torch.float32), repeats=3)
    gpu_prof.run(range(3000, 6001, 300))
    gpu_fit = gpu_prof.fit()

    def copy_rate(pinned: bool, to_card: bool) -> float:
        """Median of 3 timed 1 GiB copies, after one warm copy."""
        host = torch.ones(1 << 28, dtype=torch.float32, pin_memory=pinned)
        card_t = torch.ones(1 << 28, dtype=torch.float32, device=dev)
        src, dst = (host, card_t) if to_card else (card_t, host)
        times = []
        for _ in range(4):
            t = time.perf_counter()
            dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return host.numel() * 4 / float(np.median(times[1:]))

    h2d = copy_rate(pinned=False, to_card=True)
    rates = {"pageable D2H": copy_rate(pinned=False, to_card=False),
             "pinned H2D": copy_rate(pinned=True, to_card=True),
             "pinned D2H": copy_rate(pinned=True, to_card=False)}
    say("predict", f"host-cpu torch.matmul fit: a={cpu_fit.a:.4e} s/MAC "
        f"b={cpu_fit.b:.4e} s ({1 / cpu_fit.a * 2 / 1e12:.3f} TFLOP/s), "
        f"sizes 1000..2000")
    say("predict", f"card kernel fit: a={gpu_fit.a:.4e} s/MAC "
        f"b={gpu_fit.b:.4e} s ({1 / gpu_fit.a * 2 / 1e12:.3f} TFLOP/s), "
        f"sizes 3000..6000")
    say("predict", f"1 GiB pageable H2D copy: {h2d / 1e9:.3f} GB/s (the "
        f"CopyModel); not modelled: " + ", ".join(
            f"{k} {v / 1e9:.3f} GB/s" for k, v in rates.items()))
    for r in gpu_prof.records:
        say("predict", f"  card {r.size}^3: {r.seconds * 1e3:.3f} ms "
            f"({2 * r.ops / r.seconds / 1e12:.2f} TFLOP/s)")
    # No row grain for the card: K1 masks its edge tiles, and adapt hands
    # the rows a grain rounds away to the other device (a 128-row grain
    # cost the host up to 0.35 s of extra work at i1).
    fitted = [DeviceProfile("host-cpu", "cpu", cpu_fit, NO_COPY),
              DeviceProfile("h100", "gpu", gpu_fit,
                            CopyModel(h2d, dtype_size=4))]
    say("predict", f"done in {time.perf_counter() - t0:.1f} s")

    # ---- 3b. kernel vs plain version at the main path's card shape -------
    hg = HGemms(fitted, device="cuda")
    plan = hg.plan(M, N, K)
    card_rows = max(asg.m for d, asg in zip(hg.devices,
                                            plan.adapted.assignments)
                    if d.kind != "cpu")
    a_dev = randn(card_rows, K, dtype=torch.float32)
    b_dev = randn(K, N, dtype=torch.float32)
    sample = torch.randperm(card_rows, generator=gen, device=dev)[:SAMPLE_ROWS]
    main_row = compare(a_dev, b_dev, "float32", F32_TOL,
                       "main-path partition", exact_rows=sample)
    del a_dev, b_dev
    torch.cuda.empty_cache()
    check(main_row["violations"] == 0,
          f"kernel disagrees with plain version at the main path's shape: "
          f"{main_row}")

    # ---- 5. main path: co-execution at i1 --------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    a = rng.standard_normal((M, K), dtype=np.float32)
    b = rng.standard_normal((K, N), dtype=np.float32)
    say("main", f"A, B of i1 ({M}x{K}x{N} float32) made in "
        f"{time.perf_counter() - t0:.1f} s")
    for d, asg in zip(hg.devices, plan.adapted.assignments):
        say("main", f"plan: {d.name:9s} rows {asg.row0}..{asg.row0 + asg.m} "
            f"share {asg.ops / (float(M) * N * K) * 100:.3f}%")

    b64 = b.astype(np.float64)
    rows = np.sort(np.random.default_rng(1).choice(M, SAMPLE_ROWS,
                                                   replace=False))

    def run(hgemms, p, label):
        c, rep = hgemms.execute(a, b, plan=p)
        say("main", f"{label}: predicted makespan "
            f"{rep.predicted_makespan:.4f} s; measured makespan "
            f"{rep.measured.makespan:.4f} s; wall {rep.wall_seconds:.4f} s")
        for e in sorted(rep.measured.events, key=lambda e: e.start):
            say("main", f"  measured {e.device:9s} {e.kind:8s} chunk "
                f"{e.chunk} {e.start:.4f} -> {e.end:.4f} s")
        bus_invariants(rep.measured, p.schedule.timeline)
        check_rows(c, a, b64, rows, label)
        return rep

    for e in sorted(plan.schedule.timeline.events, key=lambda e: e.start):
        say("main", f"  planned  {e.device:9s} {e.kind:8s} chunk {e.chunk} "
            f"{e.start:.4f} -> {e.end:.4f} s")
    matmul.launches = 0
    rep = run(hg, plan, "co-execution")
    launches = matmul.launches
    say("main", f"co-execution: kernel launches {launches}; bus invariants "
        f"hold on the measured timeline")
    check(launches > 0, "the main path launched no kernel")

    # The card alone, the paper's baseline (not a gate), in turns with a
    # second co-executed run: co, alone, alone, co.
    hg1 = HGemms(fitted[1:], device="cuda")
    plan1 = hg1.plan(M, N, K)
    alone = [run(hg1, plan1, "card alone") for _ in range(2)]
    co = [rep, run(hg, plan, "co-execution (repeat)")]
    say("main", "co-execution speedup over the card alone: measured "
        + ", ".join(f"{x.measured.makespan / y.measured.makespan:.4f}x"
                    for x, y in zip(alone, co))
        + f"; predicted "
        f"{plan1.schedule.timeline.makespan / plan.schedule.timeline.makespan:.4f}x")
    say("main", f"total {time.perf_counter() - t_start:.1f} s")

    kernels = [{"name": "matmul", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/matmul.cu",
                "replaces": "src/repro/kernels/matmul.py:35",
                "launches": launches,
                "max_abs_err": main_row["max_abs_err"],
                "ms": main_row["kernel_ms"],
                "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"],
                "bound_by": main_row["bound_by"],
                "library_ms": main_row["library_ms"]}]
    print(smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
