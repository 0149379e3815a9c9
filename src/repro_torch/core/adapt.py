"""POAS phase 3 — *Adapt*.

Maps solver outputs (op counts per device) back onto problem coordinates.
For GEMM this is the paper's ``ops_to_mnk`` algorithm (§4.3):

* data adjustments — fix ``n`` and ``k`` to their original values, derive
  ``m_x = c_x / (n*k)``, then decompose each device's slice into near-square
  sub-products maximizing the squareness heuristic (Eq. 5);
* hardware adjustments — round ``m_x`` to each device's alignment grain
  (tensor cores: multiples of 8; TPU MXU: sublane grain), and bound
  sub-product working sets by the device cache/VMEM size.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .device_model import DeviceProfile


# ---------------------------------------------------------------------------
# Squareness heuristic (paper Eq. 5)
# ---------------------------------------------------------------------------


def squareness(ms: Sequence[int], ks: Sequence[int], n: int) -> float:
    """sq = Σ_i min(m'_i,k'_i)/max(m'_i,k'_i) * m'_i*k'_i*n   (Eq. 5)."""
    sq = 0.0
    for m_i, k_i in zip(ms, ks):
        if m_i <= 0 or k_i <= 0:
            continue
        sq += (min(m_i, k_i) / max(m_i, k_i)) * float(m_i) * k_i * n
    return sq


def _divisors(x: int) -> list[int]:
    out = []
    i = 1
    while i * i <= x:
        if x % i == 0:
            out.append(i)
            if i != x // i:
                out.append(x // i)
        i += 1
    return sorted(out)


@dataclasses.dataclass(frozen=True)
class SubProduct:
    """One sub-GEMM tile: (m', n, k') with row/col offsets into the slice."""
    m: int
    k: int
    row0: int
    k0: int


def decompose_square(m: int, k: int, n: int, *,
                     ops_lo: float = 0.0, ops_hi: float = math.inf,
                     max_candidates: int = 64,
                     max_tiles: int = 4096) -> list[SubProduct]:
    """Paper §4.3.1 task (2): express an (m,n,k) product as a best-effort list
    of near-square sub-products.

    ``k'`` is restricted to divisors of ``k`` (so A tiles never leave gaps in
    the k direction — paper: "k % k' == 0").  For each candidate ``k'`` we
    choose ``m'`` as close to ``k'`` as possible subject to the profiled op
    range [ops_lo, ops_hi] (sub-products must match the op counts seen during
    profiling, §5.1.3), then score the full tiling with Eq. 5 and keep the
    argmax.
    """
    if m <= 0 or k <= 0:
        return []
    best: tuple[float, list[SubProduct]] | None = None
    divs = _divisors(k)
    if len(divs) > max_candidates:  # keep the largest (most square) ones
        divs = divs[-max_candidates:]
    for kp in divs:
        # Candidate m' targets: as square as possible, inside the ops window.
        m_lo = max(1, int(math.ceil(ops_lo / (float(kp) * n))) if ops_lo else 1)
        m_hi = min(m, int(ops_hi // (float(kp) * n)) if ops_hi < math.inf else m)
        if m_hi < 1:
            continue
        mp = min(max(kp, m_lo), m_hi)  # closest to square within window
        if (-(-m // mp)) * (-(-k // kp)) > max_tiles:
            continue  # degenerate tiny tiles — skip candidate
        tiles: list[SubProduct] = []
        ms, ks = [], []
        row = 0
        while row < m:
            h = min(mp, m - row)
            col = 0
            while col < k:
                w = min(kp, k - col)
                tiles.append(SubProduct(m=h, k=w, row0=row, k0=col))
                ms.append(h)
                ks.append(w)
                col += w
            row += h
        score = squareness(ms, ks, n)
        if best is None or score > best[0]:
            best = (score, tiles)
    return best[1] if best else [SubProduct(m=m, k=k, row0=0, k0=0)]


# ---------------------------------------------------------------------------
# ops_to_mnk (paper §4.3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceAssignment:
    device: str
    m: int              # rows of the output slice
    row0: int           # starting row in the global C
    ops: float          # m * n * k actually assigned
    sub_products: list[SubProduct] = dataclasses.field(default_factory=list)
    # Pipelined-copy row chunks (device ``pipeline_chunks`` mapped to
    # contiguous align_m-sized row groups; sums to ``m``).  The runtime
    # streams A/C chunk by chunk so compute on chunk 1 overlaps the
    # transfer of chunk 2 (core.bus).
    chunk_rows: tuple[int, ...] = ()

    def chunk_offsets(self) -> list[int]:
        out, acc = [], self.row0
        for r in self.chunk_rows:
            out.append(acc)
            acc += r
        return out


@dataclasses.dataclass
class GemmPlan:
    m: int
    n: int
    k: int
    assignments: list[DeviceAssignment]

    def total_rows(self) -> int:
        return sum(a.m for a in self.assignments)


def ops_to_mnk(devices: Sequence[DeviceProfile], ops: Sequence[float],
               m: int, n: int, k: int, *,
               decompose: bool = True,
               ops_windows: Sequence[tuple[float, float]] | None = None
               ) -> GemmPlan:
    """Map solver op counts to row slices of C (paper §4.3.1 task (1)).

    ``n`` and ``k`` stay at their original values (partial-``n`` splits would
    produce partial sums of C; fixed ``k`` means only rows are distributed) so
    ``m_x = c_x / (n*k)``.  Rows are rounded to each device's ``align_m``
    grain with largest-remainder distribution so that ``Σ m_x == m`` exactly;
    leftover rows go to the fastest device (it absorbs slack with least
    makespan damage).
    """
    nk = float(n) * k
    raw = [c / nk for c in ops]
    # 1. floor to alignment grain
    m_i = [int(r // max(d.align_m, 1)) * max(d.align_m, 1)
           for r, d in zip(raw, devices)]
    # 2. distribute remaining rows in align_m-sized packets, preferring the
    #    device with the largest fractional shortfall whose packet still
    #    fits; a final partial packet goes to the smallest-alignment device
    #    (alignment broken only as a last resort).
    def speed(i):
        return devices[i].effective_speed
    remaining = m - sum(m_i)
    while remaining > 0:
        fitting = [i for i in range(len(devices))
                   if max(devices[i].align_m, 1) <= remaining]
        if fitting:
            i = max(fitting, key=lambda j: (raw[j] - m_i[j], speed(j)))
            packet = max(devices[i].align_m, 1)
        else:
            i = min(range(len(devices)),
                    key=lambda j: (max(devices[j].align_m, 1), -speed(j)))
            packet = remaining
        m_i[i] += packet
        remaining -= packet
    # 3. over-assignment (alignment rounding can exceed m): trim from the
    #    slowest devices first.
    if remaining < 0:
        for i in sorted(range(len(devices)), key=speed):
            while remaining < 0 and m_i[i] > 0:
                take = min(max(devices[i].align_m, 1), m_i[i], -remaining)
                m_i[i] -= take
                remaining += take
    assert sum(m_i) == m, (m_i, m)

    assignments: list[DeviceAssignment] = []
    row = 0
    for j, (d, rows) in enumerate(zip(devices, m_i)):
        subs: list[SubProduct] = []
        if rows > 0 and decompose:
            lo, hi = (0.0, math.inf)
            if ops_windows is not None:
                lo, hi = ops_windows[j]
            cache_hi = _cache_ops_bound(d, n)
            subs = decompose_square(rows, k, n, ops_lo=lo,
                                    ops_hi=min(hi, cache_hi))
        assignments.append(DeviceAssignment(
            device=d.name, m=rows, row0=row, ops=float(rows) * n * k,
            sub_products=subs,
            chunk_rows=_row_chunks(rows, getattr(d, "pipeline_chunks", 1),
                                   max(d.align_m, 1))))
        row += rows
    return GemmPlan(m=m, n=n, k=k, assignments=assignments)


def _row_chunks(rows: int, chunks: int, grain: int) -> tuple[int, ...]:
    """Split ``rows`` into up to ``chunks`` contiguous groups, each (except
    possibly the last) a multiple of ``grain`` — the hardware-adjustment
    rule (§4.3.2) applied at pipeline-chunk granularity.  Fewer chunks come
    back when ``rows`` is too small to split at the grain."""
    if rows <= 0:
        return ()
    chunks = max(1, int(chunks))
    if chunks == 1:
        return (rows,)
    per = max(grain, -(-rows // (chunks * grain)) * grain)
    out: list[int] = []
    left = rows
    while left > 0 and len(out) < chunks - 1:
        take = min(per, left)
        out.append(take)
        left -= take
    if left > 0:
        out.append(left)
    return tuple(out)


def _cache_ops_bound(d: DeviceProfile, n: int) -> float:
    """Hardware adjustment (paper §4.3.2, CPU case): sub-product working set
    (A tile + B panel + C tile) must fit the device cache / VMEM."""
    if math.isinf(d.cache_bytes):
        return math.inf
    dt = max(d.copy.dtype_size, 4)
    # working set for an (m',n,k') tile with m'≈k': m'k' + k'n + m'n elements.
    # Solve m'^2 + 2*m'*n <= cache/dt  for m'=k'.
    cap = d.cache_bytes / dt
    mp = (-2.0 * n + math.sqrt(4.0 * n * n + 4.0 * cap)) / 2.0
    mp = max(mp, 1.0)
    return mp * mp * n  # ops of one square tile


def plan_ops(plan: GemmPlan) -> list[float]:
    return [a.ops for a in plan.assignments]


# ---------------------------------------------------------------------------
# Generic adapt primitives (shared by the serving and train-step domains)
# ---------------------------------------------------------------------------


def pack_largest_first(weights: Sequence[float],
                       budgets: Sequence[float]) -> list[list[int]]:
    """Greedy largest-first packing of weighted items into budgeted buckets.

    Items are placed heaviest-first into the bucket with the most remaining
    budget, so bucket weight totals track the budgets (the solver's op
    shares) to within one item.  Returns item *indices* per bucket.
    """
    remaining = [float(b) for b in budgets]
    buckets: list[list[int]] = [[] for _ in budgets]
    order = sorted(range(len(weights)), key=lambda i: -weights[i])
    for idx in order:
        g = max(range(len(remaining)), key=lambda j: remaining[j])
        buckets[g].append(idx)
        remaining[g] -= weights[idx]
    return buckets


def round_shares_to_grain(raw: Sequence[float], grains: Sequence[int],
                          total: int) -> list[int]:
    """Round fractional shares to per-bucket grains, conserving ``total``.

    Floors each share to its grain, then hands out the remainder in
    grain-sized packets by largest fractional shortfall; over-assignment is
    trimmed from the largest bucket (it absorbs the change with the least
    relative distortion).  The hetero-DP domain uses this for the paper's
    hardware-adjustment step (§4.3.2) in batch-row coordinates.
    """
    grains = [max(int(g), 1) for g in grains]
    sizes = [int(r // g) * g for r, g in zip(raw, grains)]
    rem = total - sum(sizes)
    order = sorted(range(len(raw)),
                   key=lambda i: -(raw[i] - sizes[i]))
    j = 0
    while rem > 0:
        i = order[j % len(order)]
        add = min(grains[i], rem)
        sizes[i] += add
        rem -= add
        j += 1
    while rem < 0:
        i = max(range(len(sizes)), key=lambda q: sizes[q])
        take = min(grains[i], sizes[i], -rem)
        sizes[i] -= take
        rem += take
    return sizes
