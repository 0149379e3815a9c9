"""Arithmetic the per-layer metrics' readers share."""
from __future__ import annotations

from ..costs.kernels import OPS


def roofline(ctx, ops: tuple) -> float | None:
    """Σ bound ÷ Σ device time over the traced calls of the operators
    ``ops``, in %: a call's bound is the larger of its operations over the
    peak rate and its bytes over the peak bandwidth.  None where the trace
    holds no such call."""
    calls = [c for c in (ctx.trace.ops if ctx.trace else ())
             if c.name in ops and c.device_s > 0]
    if not calls:
        return None
    bound = 0.0
    for c in calls:
        flops, nbytes = OPS[c.name](c.shapes, c.sizes, c.scalars)
        bound += max(flops / ctx.peaks["flops_per_s"],
                     nbytes / ctx.peaks["bytes_per_s"])
    return 100.0 * bound / sum(c.device_s for c in calls)


def idle_share(ctx) -> float | None:
    """The share of the traced segment's wall time in which no operation
    ran on the device, in %."""
    t = ctx.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
