"""Readings several metrics share."""

from __future__ import annotations


def idle_share(ctx):
    """Percent of the traced window in which no operation ran on the
    device."""
    tr = ctx.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * max(0.0, tr.window_s - tr.busy_s()) / tr.window_s


def tier_ms_per_batch(ctx, tiers) -> float | None:
    """Milliseconds of self time in ``tiers`` per ``query.batch`` span:
    the spans of the engine's micro-batches and all they enclose."""
    roots = [r for r in ctx.counters.get("spans", ())
             if r.name == "query.batch"]
    if not roots:
        return None
    total = sum(s.self_time_s for r in roots for s in r.iter_spans()
                if s.tier in tiers)
    return 1e3 * total / len(roots)
