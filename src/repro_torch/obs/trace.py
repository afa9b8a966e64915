"""Span tracing for the serving path — deterministic, injectable-clock.

One traversal request crosses five layers (router -> engine micro-batch
-> hot-set tier -> PG-Fuse -> decode), each with its own ``*Stats``
accounting but — before this module — no way to follow a SINGLE request
through them.  :class:`Tracer` produces that view: every instrumented
layer opens a :class:`Span` around its work, spans nest by the calling
thread's :class:`TraceContext`, and a finished root span is a tree
attributing the request's (virtual-clock) time to tiers:

``request``  the traversal service's per-request envelope
``route``    scatter-gather routing in the sharded service
``gather``   the engine's micro-batch (``query.batch``: dedup, scatter,
             result assembly), its fetch (``query.offsets`` /
             ``query.packed``: run merging and PG-Fuse's cached-block
             assembly), the hot-set tier (``query.hotset.lookup`` /
             ``.observe`` / ``.fill``) and the tier's prefetch
             (``query.prefetch``)
``storage``  PG-Fuse underlying reads (cache misses only — hits never
             touch storage and correctly attribute nothing here)
``decode``   eq. (1), host or device (``query.decode``, whose
             ``bytes_h2d`` attribute carries the device arm's copy)
``h2d``      the GNN server's feature copy (``gnn.h2d``)

Design constraints, all load-bearing:

* **no globals** — a ``Tracer`` is an ordinary object injected into the
  components that should trace (``NeighborQueryEngine(tracer=...)``,
  ``ShardedQueryService(tracer=...)``, ``TraversalService(tracer=...)``,
  ``PGFuseFS.tracer``).  Two services with two tracers never share
  state;
* **zero-cost when disabled** — :data:`NULL_TRACER` (the default
  everywhere) returns one shared no-op handle; the serving path adds
  only an attribute load + a no-op context manager per span site, and
  the bench lane's tracked gates prove no regression;
* **deterministic** — span ids come from a seeded counter, timestamps
  from the injectable ``clock`` (benchmarks pass the SimStorage virtual
  clock), and sampling is a modular counter over root spans — so two
  same-seed runs produce bit-identical span trees (asserted by
  ``tests/test_obs_tracing.py``);
* **bounded** — at most ``max_traces`` finished roots are retained
  (``dropped_traces`` counts the overflow), and sampling keeps only
  every ``sample_every``-th root, suppressing the whole subtree of an
  unsampled request (children of a suppressed span never become roots).

Span **events** mark point occurrences inside a span: PG-Fuse transient
retries (``"retry"``), replica failovers (``"reroute"``), admission
sheds (``"shed"``), micro-batch window closes (``"window_close"``,
with the :data:`repro_torch.query.window.CLOSE_REASONS` reason).  Event
counts reconcile exactly with the stats counters they shadow
(``PGFuseStats.retried_reads``, ``RouterStats.reroutes``,
``TraversalStats.shed``, ``QueryStats.close_reasons``) — the
conservation cross-checks ``repro_torch.obs.report`` verifies and the
differential fuzzers assert.

**Profiler ranges.**  While a ``torch.profiler`` session is recording,
every span a :class:`Tracer` records also opens a
``torch.profiler.record_function`` range of the same name on the same
thread, so the span appears in the profiler's trace (a
``user_annotation`` event) on the clock of the device operations, and
an idle gap of the device can be named by the span that was open.  A
profiler records another thread's ranges only when it was started with
``_ExperimentalConfig(profile_all_threads=True)``.  Suppressed spans
and :data:`NULL_TRACER` emit nothing.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, List, Optional, Tuple

#: tiers the attribution report names; spans may carry other tier
#: strings ("request", "other") but those count as untiered time
NAMED_TIERS = ("route", "gather", "storage", "decode", "h2d")

#: tiers allowed to START a trace (root spans).  Orphan spans of other
#: tiers — e.g. a storage read issued by a background producer thread
#: with no request context — are suppressed rather than recorded as
#: meaningless single-span traces.
ROOT_TIERS = ("request", "route", "gather")


class SpanEvent:
    """A point occurrence inside a span (retry, reroute, shed, ...)."""

    __slots__ = ("name", "t", "attrs")

    def __init__(self, name: str, t: float, attrs: dict):
        self.name = name
        self.t = t
        self.attrs = attrs

    def as_dict(self) -> dict:
        return {"name": self.name, "t": self.t, "attrs": dict(self.attrs)}


class Span:
    """One timed tree node; built by :meth:`Tracer.span`, closed by the
    ``with`` block.  ``self_time_s`` (duration minus children) is the
    quantity the per-tier attribution sums, so nested same-tier spans
    (an engine storage span over a PG-Fuse storage span) never double
    count."""

    __slots__ = ("span_id", "parent_id", "name", "tier", "t0", "t1",
                 "attrs", "events", "children")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 tier: str, t0: float, attrs: dict):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.tier = tier
        self.t0 = t0
        self.t1 = t0
        self.attrs = attrs
        self.events: List[SpanEvent] = []
        self.children: List["Span"] = []

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    @property
    def self_time_s(self) -> float:
        """Exclusive time: duration minus the children's durations."""
        return self.duration_s - sum(c.duration_s for c in self.children)

    def iter_spans(self):
        """Pre-order walk of the subtree rooted here."""
        yield self
        for c in self.children:
            yield from c.iter_spans()

    def event_count(self, name: str) -> int:
        """Occurrences of event ``name`` across the whole subtree."""
        return sum(sum(1 for e in s.events if e.name == name)
                   for s in self.iter_spans())

    def as_dict(self) -> dict:
        """Fully serialized subtree — the bit-for-bit comparison surface
        the same-seed determinism tests pin."""
        return {
            "span_id": self.span_id, "parent_id": self.parent_id,
            "name": self.name, "tier": self.tier,
            "t0": self.t0, "t1": self.t1, "attrs": dict(self.attrs),
            "events": [e.as_dict() for e in self.events],
            "children": [c.as_dict() for c in self.children],
        }


class TraceContext:
    """Per-thread propagation state: the open-span stack plus the
    suppression depth (non-zero while inside an unsampled or orphan
    subtree).  Created lazily per thread by the tracer; user code never
    constructs one — it propagates implicitly through nested ``with
    tracer.span(...)`` blocks and explicitly across threads via
    :meth:`Tracer.attach`."""

    __slots__ = ("stack", "suppress")

    def __init__(self):
        self.stack: List[Span] = []
        self.suppress = 0


def _profiler_range(name: str):
    """An open ``record_function`` range named ``name`` while a
    ``torch.profiler`` session is recording, else None.  Reads
    PyTorch's own process-wide flag; a process that never imported
    ``torch.autograd.profiler`` runs no profiler."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return None
    rf = prof.record_function(name)
    rf.__enter__()
    return rf


class profiler_range:
    """``with profiler_range(name):`` -- a ``record_function`` range
    named ``name`` around the block while a ``torch.profiler`` session
    records (:func:`_profiler_range`), a no-op otherwise.  Model code
    names its phases with it and needs no :class:`Tracer`."""

    __slots__ = ("_name", "_range")

    def __init__(self, name: str):
        self._name = name
        self._range = None

    def __enter__(self) -> "profiler_range":
        self._range = _profiler_range(self._name)
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        return False


class _SpanHandle:
    """The live handle a ``with tracer.span(...) as sp:`` block holds."""

    __slots__ = ("_tracer", "span", "_range")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span
        self._range = _profiler_range(span.name)

    def __enter__(self) -> "_SpanHandle":
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._finish(self.span)
        if self._range is not None:
            self._range.__exit__(None, None, None)
        return False

    def event(self, name: str, **attrs) -> None:
        self.span.events.append(
            SpanEvent(name, self._tracer._clock(), attrs))

    def set(self, **attrs) -> None:
        self.span.attrs.update(attrs)


class _SuppressedHandle:
    """Handle for spans inside an unsampled/orphan subtree: keeps the
    suppression depth balanced, records nothing."""

    __slots__ = ("_tracer",)

    def __init__(self, tracer: "Tracer"):
        self._tracer = tracer

    def __enter__(self) -> "_SuppressedHandle":
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._ctx().suppress -= 1
        return False

    def event(self, name: str, **attrs) -> None:
        pass

    def set(self, **attrs) -> None:
        pass


class _NullHandle:
    """The one shared no-op handle :data:`NULL_TRACER` hands out."""

    __slots__ = ()

    def __enter__(self) -> "_NullHandle":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def event(self, name: str, **attrs) -> None:
        pass

    def set(self, **attrs) -> None:
        pass


_NULL_HANDLE = _NullHandle()


class NullTracer:
    """Disabled tracing: every call is a no-op on shared singletons, so
    an uninstrumented serving path and one built with the default
    ``tracer=None`` are the same code at the same cost."""

    enabled = False
    traces: Tuple[Span, ...] = ()
    dropped_traces = 0

    def span(self, name: str, tier: str = "other", **attrs) -> _NullHandle:
        return _NULL_HANDLE

    def event(self, name: str, **attrs) -> None:
        pass

    def attach(self, span) -> _NullHandle:
        return _NULL_HANDLE

    @property
    def current(self) -> None:
        return None

    def drain(self) -> list:
        return []


#: the module-wide disabled tracer every component defaults to
NULL_TRACER = NullTracer()


class Tracer:
    """Span recorder with deterministic ids and an injectable clock.

    ``sample_every=N`` records every N-th root span (and its whole
    subtree); the requests in between cost one suppressed-handle
    allocation per span site.  ``seed`` starts the span-id counter —
    two tracers with the same seed over the same single-threaded call
    sequence assign identical ids.  ``clock`` is any ``() -> float``;
    benches pass the SimStorage charged clock so span durations are
    virtual (machine-independent) seconds.
    """

    enabled = True

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter,
                 sample_every: int = 1, seed: int = 0,
                 max_traces: int = 256,
                 root_tiers: Tuple[str, ...] = ROOT_TIERS):
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, "
                             f"got {sample_every}")
        self._clock = clock
        self.sample_every = int(sample_every)
        self.root_tiers = tuple(root_tiers)
        self.max_traces = int(max_traces)
        self._next_id = int(seed)
        self._roots_seen = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._suppressed = _SuppressedHandle(self)
        self.traces: List[Span] = []   # finished sampled roots, in order
        self.dropped_traces = 0

    # -- propagation state -------------------------------------------------
    def _ctx(self) -> TraceContext:
        ctx = getattr(self._local, "ctx", None)
        if ctx is None:
            ctx = self._local.ctx = TraceContext()
        return ctx

    @property
    def current(self) -> Optional[Span]:
        """The calling thread's innermost open span (None outside any)."""
        stack = self._ctx().stack
        return stack[-1] if stack else None

    # -- span lifecycle ----------------------------------------------------
    def span(self, name: str, tier: str = "other", **attrs):
        """Open a span; use as ``with tracer.span(...) as sp:``.

        A span opened with no parent in this thread is a ROOT: it is
        recorded only if its tier is in ``root_tiers`` AND the sampler
        selects it; otherwise the whole subtree is suppressed (children
        never become accidental roots).
        """
        ctx = self._ctx()
        if ctx.suppress:
            ctx.suppress += 1
            return self._suppressed
        parent = ctx.stack[-1] if ctx.stack else None
        if parent is None:
            if tier not in self.root_tiers:
                ctx.suppress += 1
                return self._suppressed
            with self._lock:
                nth = self._roots_seen
                self._roots_seen += 1
            if nth % self.sample_every:
                ctx.suppress += 1
                return self._suppressed
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        sp = Span(sid, parent.span_id if parent is not None else None,
                  name, tier, self._clock(), attrs)
        if parent is not None:
            parent.children.append(sp)
        ctx.stack.append(sp)
        return _SpanHandle(self, sp)

    def _finish(self, sp: Span) -> None:
        sp.t1 = self._clock()
        stack = self._ctx().stack
        assert stack and stack[-1] is sp, "span exited out of order"
        stack.pop()
        if sp.parent_id is None:
            with self._lock:
                if len(self.traces) < self.max_traces:
                    self.traces.append(sp)
                else:
                    self.dropped_traces += 1

    def event(self, name: str, **attrs) -> None:
        """Attach an event to the calling thread's current span (dropped
        silently outside any span — orphan events have no tree to live
        in)."""
        cur = self.current
        if cur is not None:
            cur.events.append(SpanEvent(name, self._clock(), attrs))

    def attach(self, span: Span):
        """Adopt ``span`` as the calling thread's current parent — the
        explicit cross-thread propagation hook (a worker thread doing a
        request's work on its behalf)::

            with tracer.attach(request_span):
                ...   # spans opened here nest under request_span
        """
        return _AttachHandle(self, span)

    def drain(self) -> List[Span]:
        """Return and clear the retained traces (exposition reads this
        so long-running servers do not accumulate unboundedly)."""
        with self._lock:
            out, self.traces = self.traces, []
        return out


class _AttachHandle:
    """Context manager pushing an existing span as this thread's
    current parent (see :meth:`Tracer.attach`)."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: Tracer, span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._ctx().stack.append(self._span)
        return self._span

    def __exit__(self, *exc) -> bool:
        stack = self._tracer._ctx().stack
        assert stack and stack[-1] is self._span
        stack.pop()
        return False
