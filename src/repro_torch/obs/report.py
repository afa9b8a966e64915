"""Per-tier time attribution and the bottleneck report.

The paper's core figures (Figs. 2-4) attribute load time to layers —
storage calls vs block cache vs decompression.  This module produces
the same shaped answer for our serving stack from sampled span trees:
for one request, how much (virtual-clock) time went to routing,
gather machinery, storage reads, decode, and H2D?

Attribution sums each span's EXCLUSIVE time (``Span.self_time_s`` —
duration minus children) into its tier, so nested same-tier spans
(an engine-level storage span over the PG-Fuse read spans it caused)
never double count, and the per-tier times plus untiered overhead sum
exactly to the root's duration.  ``coverage`` is the named-tier
fraction of the root — the acceptance bar requires >= 0.95 on a
sharded traversal under the virtual clock.

Also here: the span/stats conservation helpers the differential
fuzzers assert (event counts in a trace set must equal the stats
counters they shadow) and structural span-tree validation.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from .trace import NAMED_TIERS, Span


def tier_times(root: Span) -> Dict[str, float]:
    """Exclusive time per tier over the whole tree (all tiers seen,
    not just the named ones)."""
    out: Dict[str, float] = {}
    for s in root.iter_spans():
        out[s.tier] = out.get(s.tier, 0.0) + s.self_time_s
    return out

def attribution(root: Span) -> dict:
    """Attribute the root's duration to named tiers.

    Returns ``{"total_s", "tiers": {tier: s}, "untiered_s",
    "coverage"}`` where ``tiers`` covers :data:`~repro_torch.obs.trace
    .NAMED_TIERS`, ``untiered_s`` is everything else (request envelope
    overhead, unnamed spans), and ``coverage`` = named / total.
    """
    times = tier_times(root)
    tiers = {t: times.get(t, 0.0) for t in NAMED_TIERS}
    total = root.duration_s
    named = sum(tiers.values())
    return {
        "total_s": total,
        "tiers": tiers,
        "untiered_s": total - named,
        "coverage": named / total if total > 0 else 1.0,
    }


def event_counts(traces: Iterable[Span], name: str) -> int:
    """Occurrences of event ``name`` across a set of traces — compared
    against the stats counter the event shadows (``retry`` vs
    ``PGFuseStats.retried_reads``, ``reroute`` vs
    ``RouterStats.reroutes``, ``shed`` vs ``TraversalStats.shed``)."""
    return sum(root.event_count(name) for root in traces)


def window_close_counts(traces: Iterable[Span]) -> Dict[str, int]:
    """Per-reason totals of ``window_close`` events — reconciles with
    ``QueryStats.close_reasons`` when every batch is traced."""
    out: Dict[str, int] = {}
    for root in traces:
        for s in root.iter_spans():
            for e in s.events:
                if e.name == "window_close":
                    reason = e.attrs.get("reason", "?")
                    out[reason] = out.get(reason, 0) + 1
    return out


def verify_span_tree(root: Span) -> List[str]:
    """Structural invariants of one trace; returns violation messages
    (empty == valid).  Checked by the differential fuzzers on every
    sampled trace:

    * every span's ``t1 >= t0`` (the injectable clock is monotonic);
    * every child lies within its parent's [t0, t1] window;
    * ``parent_id`` links match the tree structure;
    * span ids are unique within the tree.
    """
    problems: List[str] = []
    seen: Dict[int, str] = {}
    for s in root.iter_spans():
        if s.t1 < s.t0:
            problems.append(f"span {s.span_id} ({s.name}): t1 < t0")
        if s.span_id in seen:
            problems.append(f"span id {s.span_id} duplicated "
                            f"({seen[s.span_id]} and {s.name})")
        seen[s.span_id] = s.name
        for c in s.children:
            if c.parent_id != s.span_id:
                problems.append(f"span {c.span_id} ({c.name}): "
                                f"parent_id {c.parent_id} != "
                                f"{s.span_id}")
            if c.t0 < s.t0 or c.t1 > s.t1:
                problems.append(f"span {c.span_id} ({c.name}): outside "
                                f"parent {s.span_id} window")
        for e in s.events:
            if not (s.t0 <= e.t <= s.t1):
                problems.append(f"event {e.name} in span {s.span_id}: "
                                f"outside span window")
    if root.parent_id is not None:
        problems.append(f"root span {root.span_id} has parent_id "
                        f"{root.parent_id}")
    return problems


def render_report(traces: Iterable[Span]) -> str:
    """The bottleneck report: per-tier time share summed over sampled
    traces, one line per tier plus untiered overhead and coverage —
    the Fig. 2/3-shaped table for our own stack."""
    traces = list(traces)
    if not traces:
        return "tier attribution: no sampled traces"
    total = 0.0
    tiers = {t: 0.0 for t in NAMED_TIERS}
    events = 0
    for root in traces:
        att = attribution(root)
        total += att["total_s"]
        for t in NAMED_TIERS:
            tiers[t] += att["tiers"][t]
        events += sum(len(s.events) for s in root.iter_spans())
    named = sum(tiers.values())
    lines = [f"tier attribution over {len(traces)} sampled trace(s), "
             f"{total:.6g}s total, {events} event(s):"]
    for t in NAMED_TIERS:
        share = tiers[t] / total if total > 0 else 0.0
        lines.append(f"  {t:<8s} {tiers[t]:>12.6g}s  {share:>6.1%}")
    unt = total - named
    lines.append(f"  {'(other)':<8s} {unt:>12.6g}s  "
                 f"{(unt / total if total > 0 else 0.0):>6.1%}")
    lines.append(f"  coverage {named / total if total > 0 else 1.0:.1%} "
                 f"of request time attributed to named tiers")
    return "\n".join(lines)
