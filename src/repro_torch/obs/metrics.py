"""Metrics: bounded latency histogram, registry, namespace, drift check.

Three jobs, all serving the same invariant — every number the serving
stack can report has exactly one name, and folding numbers across
shards/tenants/hosts follows the same associative-merge contract the
``*Stats.merge()`` methods already obey:

* :class:`LatencyHistogram` — the fixed-size, merge-associative
  replacement for the raw per-batch latency lists ``QueryStats`` and
  ``TraversalStats`` used to retain (unbounded, and ``merge()``
  concatenated them untrimmed).  Log-spaced buckets (2% ratio) over
  [100ns, ~10^4 s]; quantiles interpolate within a bucket and clamp to
  the observed [min, max], so p50/p99 stay within ~2% of the exact
  list-based values the bench gates were tuned on (and are EXACT for
  constant distributions, which is what the virtual-clock unit tests
  pin).

* :class:`MetricsRegistry` — one flat namespace (``query.batches``,
  ``hotset.hits``, ``pgfuse.span_fetch_blocks``) every ``*Stats
  .as_dict()`` surface registers into.  Registering the same prefix
  again FOLDS: sum-kind keys add (matching each class's ``merge()``),
  ratio keys recompute from their merged parts (:data:`RATIO_SPECS`),
  and summary keys (quantiles, wall-clock) keep the max — an upper
  bound, the honest scalar fold for a quantile.  Exposition renders
  the registry as Prometheus text or a JSON snapshot.

* :data:`NAMESPACE` + :func:`metrics_drift` — the literal table of
  every registered key per prefix, diffed bidirectionally against the
  live ``as_dict()`` surfaces.  A stats field added without a
  namespace entry (or vice versa) fails
  ``.github/scripts/metrics_drift.py`` in the docs CI job, and the
  table in ``docs/observability.md`` is synced against it by
  ``tests/test_docs_sync.py``.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Optional, Tuple

# -- bounded latency histogram ---------------------------------------------

#: lower edge of the first log bucket; values at or below it (including
#: zero) land in the underflow bucket whose range is [0, LOW]
HIST_LOW_S = 1e-7
#: geometric bucket width — also the worst-case relative quantile error
HIST_RATIO = 1.02
#: log-spaced bucket count; LOW * RATIO**N ≈ 1.05e4 s top edge
HIST_N_BUCKETS = 1280

_LOG_RATIO = math.log(HIST_RATIO)


class LatencyHistogram:
    """Fixed-size log-bucket histogram of nonnegative durations.

    Storage is a sparse ``{bucket_index: count}`` dict bounded by
    ``HIST_N_BUCKETS + 2`` entries (underflow 0, log buckets 1..N,
    overflow N+1), so memory is O(1) in the number of observations and
    :meth:`merge` (sum counts, min/max fold — integer and order-
    insensitive math only, deliberately no float ``total``) is EXACTLY
    associative and commutative — the property ``QueryStats.merge`` /
    ``TraversalStats.merge`` require of every field, and what lets the
    differential fuzzers pin fold results bit-for-bit.
    """

    __slots__ = ("counts", "n", "min_s", "max_s")

    def __init__(self):
        self.counts: Dict[int, int] = {}
        self.n = 0
        self.min_s = math.inf
        self.max_s = 0.0

    @staticmethod
    def _bucket(v: float) -> int:
        if v <= HIST_LOW_S:
            return 0
        i = 1 + int(math.log(v / HIST_LOW_S) / _LOG_RATIO)
        return i if i <= HIST_N_BUCKETS else HIST_N_BUCKETS + 1

    @staticmethod
    def _edges(i: int) -> Tuple[float, float]:
        """[lower, upper] value range of bucket ``i``."""
        if i == 0:
            return 0.0, HIST_LOW_S
        return (HIST_LOW_S * HIST_RATIO ** (i - 1),
                HIST_LOW_S * HIST_RATIO ** i)

    def add(self, v: float) -> None:
        v = float(v)
        i = self._bucket(v)
        self.counts[i] = self.counts.get(i, 0) + 1
        self.n += 1
        if v < self.min_s:
            self.min_s = v
        if v > self.max_s:
            self.max_s = v

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        out = LatencyHistogram()
        out.counts = dict(self.counts)
        for i, c in other.counts.items():
            out.counts[i] = out.counts.get(i, 0) + c
        out.n = self.n + other.n
        out.min_s = min(self.min_s, other.min_s)
        out.max_s = max(self.max_s, other.max_s)
        return out

    def copy(self) -> "LatencyHistogram":
        return LatencyHistogram().merge(self)

    def quantile(self, q: float) -> float:
        """q-quantile estimate (numpy 'linear' rank convention), within
        one bucket width (~2%) of the exact list-based value and
        clamped to the observed [min, max] — exact when all
        observations are equal."""
        if not self.n:
            return 0.0
        rank = q * (self.n - 1)
        c = 0
        for i in sorted(self.counts):
            cnt = self.counts[i]
            if c + cnt > rank:
                lo, hi = self._edges(i)
                pos = (rank - c + 0.5) / cnt     # mid-rank within bucket
                v = lo + (hi - lo) * min(pos, 1.0)
                return min(max(v, self.min_s), self.max_s)
            c += cnt
        return self.max_s

    def __eq__(self, other) -> bool:
        return (isinstance(other, LatencyHistogram)
                and self.counts == other.counts and self.n == other.n
                and self.min_s == other.min_s and self.max_s == other.max_s)

    def __repr__(self) -> str:
        return (f"LatencyHistogram(n={self.n}, "
                f"buckets={len(self.counts)}, "
                f"min={self.min_s if self.n else 0.0:.3g}, "
                f"max={self.max_s:.3g})")


# -- namespace -------------------------------------------------------------

#: where each prefix's stats class lives — ``metrics_drift`` imports
#: these lazily (obs never imports repro_torch.* at module level, because the
#: stats modules import THIS module for LatencyHistogram)
STATS_SOURCES = {
    "query": ("repro_torch.query.engine", "QueryStats"),
    "traversal": ("repro_torch.query.traversal", "TraversalStats"),
    "router": ("repro_torch.query.sharded", "RouterStats"),
    "hotset": ("repro_torch.query.hotset", "HotSetStats"),
    "stream": ("repro_torch.data.graph_stream", "StreamStats"),
    "pgfuse": ("repro_torch.core.pgfuse", "PGFuseStats"),
}

#: every key each ``as_dict()`` surface exposes, per prefix.  Dict-
#: valued keys (``close_reasons`` …) appear once here and flatten to
#: ``prefix.key.subkey`` gauges at registration.  This literal IS the
#: contract: ``.github/scripts/metrics_drift.py`` fails when it and the
#: live surfaces disagree in either direction, and the table in
#: ``docs/observability.md`` must list exactly these names.
NAMESPACE = {
    "query": (
        "requests", "unique_vertices", "batches", "coalesced_reads",
        "blocks_touched", "bytes_gathered", "edges_returned",
        "device_batches", "bytes_h2d", "close_reasons", "n_latencies",
        "dedup_ratio", "p50_s", "p99_s",
    ),
    "traversal": (
        "submitted", "admitted", "shed", "completed", "failed",
        "inflight", "requests_by_kind", "frontier_batches",
        "edges_scanned", "vertices_visited", "truncated", "n_latencies",
        "p50_s", "p99_s", "shed_rate",
    ),
    "router": (
        "requests", "batches", "routed_by_shard", "shard_batches",
        "reroutes", "failed_batches",
    ),
    "hotset": (
        "lookups", "hits", "misses", "fills", "admitted", "bypassed",
        "rejected", "evicted", "pinned", "prefetch_fills",
        "prefetch_hits", "prefetch_evicted", "hit_edges",
        "resident_bytes", "resident_entries", "hit_rate",
        "prefetch_hit_rate",
    ),
    "stream": (
        "partitions", "vertices", "edges", "decode_mode",
        "decode_reason", "underlying_reads", "underlying_bytes",
        "cache_hits", "cache_misses", "readahead_blocks", "bytes_h2d",
        "host_decode_bytes", "decode_s", "feature_rows",
        "feature_bytes", "feature_bytes_h2d", "feature_read_s",
        "feature_cache_hits", "feature_cache_misses", "label_rows",
        "label_bytes", "wall_s", "decode_edges_per_s",
        "h2d_bytes_per_s", "edges_per_s", "feature_bytes_per_s",
        "feature_hit_rate",
    ),
    "pgfuse": (
        "underlying_reads", "underlying_bytes", "cache_hits",
        "cache_misses", "waits", "evictions", "bytes_served",
        "readahead_blocks", "span_fetch_blocks", "retried_reads",
        "hit_rate",
    ),
}

#: derived ratios recomputed after a fold: name -> (numerator keys,
#: denominator keys); value = sum(num) / sum(den), 0 when den == 0.
RATIO_SPECS = {
    "query.dedup_ratio": (("query.requests",), ("query.unique_vertices",)),
    "traversal.shed_rate": (("traversal.shed",), ("traversal.submitted",)),
    "hotset.hit_rate": (("hotset.hits",), ("hotset.lookups",)),
    "hotset.prefetch_hit_rate": (("hotset.prefetch_hits",),
                                 ("hotset.prefetch_fills",)),
    "pgfuse.hit_rate": (("pgfuse.cache_hits",),
                        ("pgfuse.cache_hits", "pgfuse.cache_misses")),
    "stream.decode_edges_per_s": (("stream.edges",), ("stream.decode_s",)),
    "stream.h2d_bytes_per_s": (("stream.bytes_h2d",), ("stream.wall_s",)),
    "stream.edges_per_s": (("stream.edges",), ("stream.wall_s",)),
    "stream.feature_bytes_per_s": (("stream.feature_bytes",),
                                   ("stream.wall_s",)),
    "stream.feature_hit_rate": (("stream.feature_cache_hits",),
                                ("stream.feature_cache_hits",
                                 "stream.feature_cache_misses")),
}

#: non-recomputable summary keys: folding keeps the MAX (an upper
#: bound — the honest scalar fold for a quantile or a parallel
#: wall-clock, and it matches ``StreamStats.merge``'s wall_s rule)
MAX_KEYS = frozenset({
    "query.p50_s", "query.p99_s",
    "traversal.p50_s", "traversal.p99_s",
    "stream.wall_s",
})


# -- metric primitives -----------------------------------------------------

class Counter:
    """Monotonic count; folds by summing."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self, value: float = 0):
        self.value = value

    def inc(self, n: float = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time level; ``fold`` picks sum or max per key kind."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self, value: float = 0):
        self.value = value

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Registry-resident :class:`LatencyHistogram` with metric kind."""

    __slots__ = ("hist",)
    kind = "histogram"

    def __init__(self, hist: Optional[LatencyHistogram] = None):
        self.hist = hist if hist is not None else LatencyHistogram()

    def observe(self, v: float) -> None:
        self.hist.add(v)

    @property
    def value(self) -> float:
        return self.hist.quantile(0.5)


class MetricsRegistry:
    """One flat metric namespace with fold-on-register semantics.

    ``register_stats("query", engine.stats.as_dict())`` flattens the
    dict into ``query.*`` entries.  Registering the same prefix again
    (another shard, another tenant) folds: sum-kind keys add, ratio
    keys recompute from their folded parts (:data:`RATIO_SPECS`), and
    :data:`MAX_KEYS` keep the max.  Non-numeric values (decode mode
    strings) land in the ``info`` side-channel, last-write-wins.
    """

    def __init__(self):
        self._values: Dict[str, float] = {}
        self.info: Dict[str, str] = {}
        self._sources: Dict[str, int] = {}   # prefix -> folds seen

    # -- registration ------------------------------------------------------
    def register_stats(self, prefix: str, stats: dict) -> None:
        self._sources[prefix] = self._sources.get(prefix, 0) + 1
        flat: Dict[str, float] = {}
        for key, val in stats.items():
            name = f"{prefix}.{key}"
            if isinstance(val, dict):
                for sub, v in val.items():
                    flat[f"{name}.{sub}"] = float(v)
            elif isinstance(val, str):
                self.info[name] = val
            elif isinstance(val, LatencyHistogram):
                flat[f"{name}.n"] = float(val.n)
            else:
                flat[name] = float(val)
        for name, v in flat.items():
            if name in RATIO_SPECS:
                continue                     # recomputed below
            if name in MAX_KEYS:
                self._values[name] = max(self._values.get(name, 0.0), v)
            else:
                self._values[name] = self._values.get(name, 0.0) + v
        for name in RATIO_SPECS:
            if not name.startswith(prefix + "."):
                continue
            num_keys, den_keys = RATIO_SPECS[name]
            num = sum(self._values.get(k, 0.0) for k in num_keys)
            den = sum(self._values.get(k, 0.0) for k in den_keys)
            self._values[name] = num / den if den else 0.0

    def set(self, name: str, value: float) -> None:
        """Directly set one metric (exposition-side extras like
        ``obs.dropped_traces``)."""
        self._values[name] = float(value)

    # -- reads -------------------------------------------------------------
    def get(self, name: str, default: float = 0.0) -> float:
        return self._values.get(name, default)

    def names(self) -> List[str]:
        return sorted(self._values)

    def snapshot(self) -> dict:
        """JSON-ready snapshot: sorted numeric metrics + info strings +
        per-prefix fold counts."""
        return {
            "metrics": {k: self._values[k] for k in sorted(self._values)},
            "info": dict(sorted(self.info.items())),
            "sources": dict(sorted(self._sources.items())),
        }

    # -- exposition --------------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text format: ``repro_`` prefix, dots to
        underscores, one ``# TYPE`` line per metric."""
        lines = []
        for name in sorted(self._values):
            pname = "repro_" + name.replace(".", "_").replace("-", "_")
            lines.append(f"# TYPE {pname} gauge")
            v = self._values[name]
            lines.append(f"{pname} {v:.17g}" if isinstance(v, float)
                         else f"{pname} {v}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_json(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
            f.write("\n")


def flatten_numeric(d: dict, prefix: str = "") -> Dict[str, float]:
    """Recursively flatten a nested result dict to dotted numeric keys
    (strings/lists dropped) — the shape the ``BENCH_*_metrics.json``
    sidecars persist so bench runs double as metrics-surface smoke
    tests."""
    out: Dict[str, float] = {}
    for k, v in d.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_numeric(v, name))
        elif isinstance(v, bool) or isinstance(v, (int, float)):
            out[name] = float(v)
    return out


# -- drift check -----------------------------------------------------------

def metrics_drift() -> List[str]:
    """Diff the live ``as_dict()`` surfaces against :data:`NAMESPACE`.

    Returns one message per violation (empty list == in sync): a stats
    key missing from the namespace, a namespace key the class no longer
    exposes, or a prefix whose class cannot be imported (in this port
    that includes the ``traversal``, ``router`` and ``hotset`` sources
    until those modules are ported).  In the JAX package it is run by
    ``.github/scripts/metrics_drift.py`` (docs CI job) and
    ``tests/test_docs_sync.py``.
    """
    import importlib

    problems: List[str] = []
    for prefix, (mod_name, cls_name) in sorted(STATS_SOURCES.items()):
        try:
            cls = getattr(importlib.import_module(mod_name), cls_name)
            live = set(cls().as_dict())
        except Exception as exc:   # pragma: no cover - import breakage
            problems.append(f"{prefix}: cannot load "
                            f"{mod_name}.{cls_name}: {exc!r}")
            continue
        declared = set(NAMESPACE[prefix])
        for key in sorted(live - declared):
            problems.append(
                f"{prefix}.{key}: exposed by {cls_name}.as_dict() but "
                f"missing from repro_torch.obs.metrics.NAMESPACE")
        for key in sorted(declared - live):
            problems.append(
                f"{prefix}.{key}: declared in NAMESPACE but not exposed "
                f"by {cls_name}.as_dict()")
    for prefix in sorted(set(NAMESPACE) - set(STATS_SOURCES)):
        problems.append(f"{prefix}: in NAMESPACE but has no entry in "
                        f"STATS_SOURCES")
    return problems
