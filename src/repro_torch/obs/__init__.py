"""Unified observability layer for the serving stack.

``repro_torch.obs`` gives the stack one telemetry surface (see
``docs/observability.md``):

* :mod:`repro_torch.obs.trace` — per-request span tracing with deterministic
  ids, an injectable (virtual) clock, and zero-cost no-op default;
* :mod:`repro_torch.obs.metrics` — the bounded latency histogram every stats
  class retains, plus the registry / namespace / drift check;
* :mod:`repro_torch.obs.report` — per-tier time attribution and the
  span-vs-stats conservation helpers.

This package never imports ``repro_torch.*`` at module level (the stats
modules import it), keeping the dependency direction acyclic.
"""

from .metrics import (
    LatencyHistogram,
    MetricsRegistry,
    NAMESPACE,
    RATIO_SPECS,
    STATS_SOURCES,
    flatten_numeric,
    metrics_drift,
)
from .report import (
    attribution,
    event_counts,
    render_report,
    tier_times,
    verify_span_tree,
    window_close_counts,
)
from .trace import (
    NAMED_TIERS,
    NULL_TRACER,
    NullTracer,
    ROOT_TIERS,
    Span,
    SpanEvent,
    TraceContext,
    Tracer,
)

__all__ = [
    "LatencyHistogram", "MetricsRegistry", "NAMESPACE", "RATIO_SPECS",
    "STATS_SOURCES", "flatten_numeric", "metrics_drift",
    "attribution", "event_counts", "render_report", "tier_times",
    "verify_span_tree", "window_close_counts",
    "NAMED_TIERS", "NULL_TRACER", "NullTracer", "ROOT_TIERS",
    "Span", "SpanEvent", "TraceContext", "Tracer",
]
