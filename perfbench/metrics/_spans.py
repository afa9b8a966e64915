"""Readings of the query engine's spans that several query metrics
share.  A reader returns None only where the window has no
``query.batch`` root; spans a program does not open read as 0."""

from __future__ import annotations


def roots(ctx, name: str) -> list:
    """The window's root spans named ``name``."""
    return [r for r in ctx.counters.get("spans", ()) if r.name == name]


def self_ms_per_batch(ctx, names) -> float | None:
    """Milliseconds of self time of the spans named in ``names`` under
    the ``query.batch`` roots, per root."""
    batches = roots(ctx, "query.batch")
    if not batches:
        return None
    total = sum(s.self_time_s for r in batches for s in r.iter_spans()
                if s.name in names)
    return 1e3 * total / len(batches)
