"""Arithmetic shared by the per-layer metric readers in ``metrics/``."""

from __future__ import annotations

from typing import Optional, Sequence

from benchmark.costs import psi
from benchmark.reference.fit import schedule


def idle_pct(ctx) -> Optional[float]:
    """Share of the traced window in which nothing ran on the device."""
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def per_unit(ctx, value: float) -> Optional[float]:
    units = ctx.counters.get("traced_calls", 0)
    return value / units if units else None


def roofline_pct(ctx, bound_s_per_unit: float, patterns: Sequence[str]) -> Optional[float]:
    """Least time of the traced units' work over the device time of the
    kernels that did it; nothing when those kernels did not run."""
    t = ctx.trace
    units = ctx.counters.get("traced_calls", 0)
    spent = t.device_s(patterns) if t is not None else 0.0
    if not units or spent <= 0:
        return None
    return 100.0 * units * bound_s_per_unit / spent


def rest_rate(ctx) -> Optional[float]:
    """Units a second over the window's untraced part."""
    c = ctx.counters
    if not c.get("rest_units") or not c.get("rest_s"):
        return None
    return c["rest_units"] / c["rest_s"]


def mfu_pct(ctx, flops_per_unit: float) -> Optional[float]:
    """The model operations of the window's untraced part over what the
    chip's bf16 peak does in it."""
    c = ctx.counters
    if not c.get("rest_units") or not c.get("rest_s"):
        return None
    return 100.0 * flops_per_unit * c["rest_units"] / (c["rest_s"] * psi.PEAK_BF16)


def genfit_searches(tr) -> int:
    """Iterations of a fit that search the scene cloud."""
    refresh = tr["fit"]["refresh_every"] if tr["tier"] == "production" else 1
    return sum(k != "cheap" for k in schedule(tr["num_iter"], refresh, tr["fit"]["refresh_warmup"]))


def body_sizes(cfg):
    b = cfg["body"]
    J = b["num_joints"]
    return b["num_verts"], J, b["num_betas"], (J - 1) * 9
