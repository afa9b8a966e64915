"""Multi-hop traversal service over the neighbor-query engine.

The engine answers *one* frontier; real graph serving (swh-graph's
visit API, the BFS/PageRank evaluations ParaGrapher itself is measured
with) asks *traversals*: k-hop neighborhoods, bounded BFS visits and
shortest paths.  :class:`TraversalService` is that layer, built so the
engine's whole machinery keeps paying at every hop:

* each frontier expands as **ONE batched engine call**
  (:meth:`~repro_torch.query.NeighborQueryEngine.neighbors_batch_ragged`) —
  dedup, merged range reads, span prefetch and the per-batch
  host/device decode placement (``decode="auto"`` routes large
  frontiers to the CUDA decode kernel) all apply to the frontier as a unit,
  never per vertex; when the engine carries the HBM-resident hot-set
  tier (:class:`~repro_torch.query.hotset.HotSetCache`), the frontier's hub
  vertices are answered from resident decoded runs and **skip the
  storage gather entirely** — only the frontier's cold remainder
  reaches PG-Fuse, and answers stay byte-identical either way;
* every request carries budgets — ``max_edges`` (scanned edge budget)
  and ``max_vertices`` (visit bound) — with semantics pinned precisely
  enough that a pure in-memory CSR reference reproduces the results
  bit for bit (the differential property suite asserts it);
* an **admission gate** sized by
  :func:`repro_torch.core.policy.choose_admission` sheds excess load
  *immediately* (fast-fail :class:`TraversalShed`), so overload shows
  up as an explicit shed rate while every admitted request keeps its
  latency SLO — the deterministic closed-loop load generator
  (:mod:`repro_torch.query.loadgen`) pins both properties on a virtual
  clock;
* per-request accounting folds into :class:`TraversalStats`, shaped
  like the engine's :class:`~repro_torch.query.QueryStats` (injectable-clock
  latency window, atomic :meth:`~TraversalStats.reset`, conservation
  invariants: ``admitted + shed == submitted`` and
  ``completed + failed + inflight == admitted``).

Traversal semantics (shared verbatim by the in-memory reference)
----------------------------------------------------------------

Seeds are validated against ``[0, n_vertices)`` (a bad seed is a clean
per-request :class:`TraversalError`), then deduplicated and sorted —
depth 0 of the visit.  Each hop expands the current frontier in one
engine batch; newly discovered vertices (ascending id) join the visit
at depth ``hop``.  Checked *before* each expansion, in order:

1. ``found`` (path requests) — the target entered the visit;
2. empty frontier — natural exhaustion;
3. ``hop == k`` — depth bound reached (``k=0`` visits only the seeds);
4. ``edges_scanned > max_edges`` — the PREVIOUS hop crossed the edge
   budget: its results are kept, the traversal stops ``truncated``;
5. ``len(visited) >= max_vertices`` — visit bound reached,
   ``truncated``.

``max_vertices`` also trims within a hop: newly discovered vertices
are kept in ascending order up to the remaining capacity (dropping any
marks the result ``truncated``).  Shortest-path parents are defined
order-independently: the parent of a newly discovered vertex is the
**smallest-id frontier vertex adjacent to it** (equal to the first
occurrence in the frontier-major expansion, since frontiers are
sorted), so host decode, device decode and the reference agree on the
exact path, not just its length.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core import policy as _policy
from repro_torch.obs.metrics import LatencyHistogram
from repro_torch.obs.trace import NULL_TRACER

#: default per-request scanned-edge budget (generous: bounded work per
#: request is the contract, not a tight cap)
DEFAULT_EDGE_BUDGET = 1 << 20

TRAVERSAL_KINDS = ("khop", "bfs", "path")


class TraversalError(ValueError):
    """Per-request rejection (bad seeds/arguments) — never engine state."""


class TraversalShed(RuntimeError):
    """Request refused by the admission gate (overload fast-fail)."""


@dataclasses.dataclass
class TraversalRequest:
    """One traversal request.

    ``kind`` is ``"khop"`` (neighborhood to depth ``k``), ``"bfs"``
    (visit bounded by ``max_vertices``/``max_edges``; ``k`` optionally
    bounds depth) or ``"path"`` (BFS shortest path seeds -> ``target``).
    """

    kind: str
    seeds: np.ndarray
    k: Optional[int] = None
    target: Optional[int] = None
    max_edges: int = DEFAULT_EDGE_BUDGET
    max_vertices: Optional[int] = None

    def __post_init__(self) -> None:
        if self.kind not in TRAVERSAL_KINDS:
            raise TraversalError(
                f"kind must be one of {TRAVERSAL_KINDS}, got {self.kind!r}")
        self.seeds = np.asarray(self.seeds, dtype=np.int64).ravel()
        if self.max_edges < 0:
            raise TraversalError(f"max_edges must be >= 0, "
                                 f"got {self.max_edges}")
        if self.k is not None and self.k < 0:
            raise TraversalError(f"k must be >= 0, got {self.k}")
        if self.max_vertices is not None and self.max_vertices < 1:
            raise TraversalError(f"max_vertices must be >= 1, "
                                 f"got {self.max_vertices}")
        if self.kind == "path":
            if self.target is None:
                raise TraversalError("path requests need target=")
            if self.seeds.size != 1:
                raise TraversalError("path requests take exactly one seed")
        if self.kind == "khop" and self.k is None:
            raise TraversalError("khop requests need k=")


@dataclasses.dataclass
class TraversalResult:
    """One traversal's answer + its per-request accounting."""

    kind: str
    vertices: np.ndarray        # visit in BFS order (hop-major, ascending
                                # id within each hop); int64
    depths: np.ndarray          # hop each vertex was discovered at; int64
    found: bool                 # path requests: target reached
    path: Optional[np.ndarray]  # path requests: seed..target inclusive
    truncated: bool             # a budget stopped the traversal early
    hops: int                   # frontier expansions executed
    edges_scanned: int          # neighbor slots read across all hops
    latency_s: float = 0.0      # service-clock request latency

    @property
    def n_visited(self) -> int:
        return int(self.vertices.size)


@dataclasses.dataclass
class TraversalStats:
    """Service accounting, shaped like the engine's ``QueryStats``
    (bounded latency histogram over the injectable clock, atomic
    :meth:`reset` returning the pre-reset snapshot).

    Conservation invariants — asserted by the load/soak suite, held
    under concurrent submission because every mutation happens under
    one lock:

    * ``submitted == admitted + shed``  (the gate loses nothing);
    * ``admitted == completed + failed + inflight``.
    """

    submitted: int = 0        # requests offered to the gate
    admitted: int = 0         # requests past the gate
    shed: int = 0             # requests refused by the gate
    completed: int = 0        # admitted requests answered
    failed: int = 0           # admitted requests erroring (storage etc.)
    inflight: int = 0         # admitted, not yet completed/failed
    requests_by_kind: dict = dataclasses.field(default_factory=dict)
    frontier_batches: int = 0  # engine calls (== hops across requests)
    edges_scanned: int = 0
    vertices_visited: int = 0
    truncated: int = 0         # completed requests a budget cut short
    latencies: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)

    def __post_init__(self) -> None:
        # the lock is deliberately an attribute, not a field: asdict()
        # and replace() must never try to serialize or copy it
        self._lock = threading.Lock()

    @property
    def conserved(self) -> bool:
        return (self.submitted == self.admitted + self.shed
                and self.admitted
                == self.completed + self.failed + self.inflight)

    @property
    def shed_rate(self) -> float:
        return self.shed / self.submitted if self.submitted else 0.0

    def latency_quantile(self, q: float) -> float:
        with self._lock:
            return self.latencies.quantile(q)

    @property
    def p50_s(self) -> float:
        return self.latency_quantile(0.50)

    @property
    def p99_s(self) -> float:
        return self.latency_quantile(0.99)

    def as_dict(self) -> dict:
        with self._lock:
            d = {f.name: getattr(self, f.name)
                 for f in dataclasses.fields(self)}
            hist = d.pop("latencies")
            d["requests_by_kind"] = dict(d["requests_by_kind"])
            d["n_latencies"] = hist.n
            d["p50_s"] = hist.quantile(0.50)
            d["p99_s"] = hist.quantile(0.99)
        d["shed_rate"] = (d["shed"] / d["submitted"]
                          if d["submitted"] else 0.0)
        return d

    def _snapshot(self) -> "TraversalStats":
        """A consistent copy taken under the stats lock."""
        with self._lock:
            return dataclasses.replace(
                self, latencies=self.latencies.copy(),
                requests_by_kind=dict(self.requests_by_kind))

    def merge(self, other: "TraversalStats") -> "TraversalStats":
        """Associative cross-service aggregation (returns a NEW
        instance) — the traversal-side sibling of
        :meth:`repro_torch.query.QueryStats.merge`, for folding several
        services' (or shards') accounting into fleet totals: counters
        sum, ``requests_by_kind`` sums key-wise, latency histograms
        merge bucket-wise.  Each operand is snapshotted under its
        own lock, so merging races cleanly with concurrent
        admit/complete folds and with :meth:`reset`; both conservation
        invariants (``submitted == admitted + shed``,
        ``admitted == completed + failed + inflight``) survive the
        merge because every term is a sum of terms that satisfy them.
        """
        a, b = self._snapshot(), other._snapshot()
        out = TraversalStats()
        for f in dataclasses.fields(out):
            if f.name in ("latencies", "requests_by_kind"):
                continue
            setattr(out, f.name, getattr(a, f.name) + getattr(b, f.name))
        for src in (a.requests_by_kind, b.requests_by_kind):
            for k, v in src.items():
                out.requests_by_kind[k] = out.requests_by_kind.get(k, 0) + v
        out.latencies = a.latencies.merge(b.latencies)
        return out

    def reset(self) -> "TraversalStats":
        """Zero in place ATOMICALLY; returns the pre-reset snapshot.

        In-flight requests survive a reset: ``inflight`` carries over
        (their eventual completion must still balance), everything else
        zeroes — the snapshot absorbs the finished history, the live
        object keeps only what is still outstanding, and conservation
        holds on BOTH sides of the cut.
        """
        with self._lock:
            snap = dataclasses.replace(
                self, latencies=self.latencies.copy(),
                requests_by_kind=dict(self.requests_by_kind))
            live = self.inflight
            for f in dataclasses.fields(self):
                cur = getattr(self, f.name)
                setattr(self, f.name,
                        LatencyHistogram()
                        if isinstance(cur, LatencyHistogram)
                        else [] if isinstance(cur, list)
                        else {} if isinstance(cur, dict) else 0)
            # the outstanding requests were admitted in THIS epoch now:
            # count them as submitted+admitted so the live invariant
            # (admitted == completed + failed + inflight) keeps holding
            self.inflight = live
            self.admitted = live
            self.submitted = live
            snap.inflight -= live
            snap.admitted -= live
            snap.submitted -= live
        return snap


class AdmissionGate:
    """Token gate over an :class:`repro_torch.core.policy.AdmissionPlan`.

    Thread-safe; ``try_admit`` takes both tokens (request slot + edge
    budget) or neither.  A ``plan=None`` gate admits everything.
    """

    def __init__(self, plan: Optional["_policy.AdmissionPlan"]):
        self.plan = plan
        self._lock = threading.Lock()
        self.inflight = 0
        self.edges_inflight = 0

    def try_admit(self, edge_budget: int) -> bool:
        with self._lock:
            if self.plan is not None:
                if (self.inflight + 1 > self.plan.max_inflight
                        or self.edges_inflight + edge_budget
                        > self.plan.max_edges_inflight):
                    return False
            self.inflight += 1
            self.edges_inflight += edge_budget
            return True

    def release(self, edge_budget: int) -> None:
        with self._lock:
            self.inflight -= 1
            self.edges_inflight -= edge_budget
            assert self.inflight >= 0 and self.edges_inflight >= 0


class TraversalService:
    """Traversal API over a pluggable frontier-expansion backend.

    ``engine`` is anything exposing the engine's query surface —
    ``neighbors_batch_ragged(vertices) -> (offsets, ids)``,
    ``n_vertices``, ``stats`` (a :class:`~repro_torch.query.QueryStats`) and
    ``_clock``: a single :class:`~repro_torch.query.NeighborQueryEngine`, or
    a :class:`~repro_torch.query.sharded.ShardedQueryService` that
    scatter-gathers each frontier across per-shard engines (at most one
    engine batch per shard per hop, results merged back into the same
    pinned order, so every traversal below is bit-identical regardless
    of the shard count behind it).

    Synchronous use::

        svc = TraversalService(engine, admission=plan)
        res = svc.khop([17, 404], k=2)
        res = svc.bfs_visit([0], max_vertices=1000)
        res = svc.shortest_path(0, 999)

    Concurrent serving: :meth:`submit` runs the request on a bounded
    executor (``plan.servers`` workers) after passing the gate in the
    CALLER's thread — shedding is immediate, never queued.  The
    deterministic load generator (:mod:`repro_torch.query.loadgen`) instead
    drives the :meth:`admit`/:meth:`perform`/:meth:`complete` triplet
    directly on a virtual clock.

    ``clock`` defaults to the engine's (virtual in benches/tests), so
    ``TraversalStats`` latencies and ``QueryStats`` latencies are
    measured on the same axis.
    """

    def __init__(self, engine, *,
                 admission: Optional["_policy.AdmissionPlan"] = None,
                 default_max_edges: int = DEFAULT_EDGE_BUDGET,
                 clock: Optional[Callable[[], float]] = None,
                 tracer=None):
        self._engine = engine
        self.gate = AdmissionGate(admission)
        self.default_max_edges = int(default_max_edges)
        self._clock = clock if clock is not None else engine._clock
        # share the backend's tracer by default so the request root
        # span and the engine's gather spans land in ONE trace
        self._tracer = (tracer if tracer is not None
                        else getattr(engine, "_tracer", NULL_TRACER))
        self.stats = TraversalStats()
        self._executor = None
        self._executor_lock = threading.Lock()
        self._closed = False

    # -- properties --------------------------------------------------------
    @property
    def engine(self):
        """The frontier-expansion backend (a
        :class:`NeighborQueryEngine` or sharded equivalent)."""
        return self._engine

    @property
    def n_vertices(self) -> int:
        return self._engine.n_vertices

    @property
    def plan(self) -> Optional["_policy.AdmissionPlan"]:
        return self.gate.plan

    # -- the BFS core ------------------------------------------------------
    def _validate_seeds(self, req: TraversalRequest) -> np.ndarray:
        seeds = req.seeds
        if seeds.size == 0:
            raise TraversalError("traversal needs at least one seed")
        if seeds.min() < 0 or seeds.max() >= self.n_vertices:
            raise TraversalError(
                f"seed ids must be in [0, {self.n_vertices}); got "
                f"[{seeds.min()}, {seeds.max()}]")
        if req.kind == "path" and not (
                0 <= int(req.target) < self.n_vertices):
            raise TraversalError(
                f"target must be in [0, {self.n_vertices}); "
                f"got {req.target}")
        return np.unique(seeds)

    def _traverse(self, req: TraversalRequest) -> TraversalResult:
        """The shared frontier loop (semantics in the module docstring);
        budgets and parent choice are defined so a pure CSR reference
        reproduces every field bit for bit."""
        seeds = self._validate_seeds(req)
        k = req.k
        max_vertices = (req.max_vertices if req.max_vertices is not None
                        else self.n_vertices)
        target = int(req.target) if req.kind == "path" else None
        hop_vertices: List[np.ndarray] = [seeds]
        hop_depths: List[np.ndarray] = [np.zeros(seeds.size, np.int64)]
        visited = seeds                   # sorted invariant maintained
        # parent[i] belongs to discovered[i] (path requests only)
        parent_of: dict = {}
        frontier = seeds
        # seeds beyond the visit bound are trimmed like any other hop
        truncated = False
        if seeds.size > max_vertices:
            frontier = visited = seeds[:max_vertices]
            hop_vertices[0] = frontier
            hop_depths[0] = np.zeros(frontier.size, np.int64)
            truncated = True
        found = target is not None and \
            bool(np.isin(target, frontier).item())
        edges_scanned = 0
        hops = 0
        while True:
            if found or frontier.size == 0:
                break
            if k is not None and hops == k:
                break
            if edges_scanned > req.max_edges:
                truncated = True
                break
            if visited.size >= max_vertices:
                truncated = True
                break
            # ONE engine batch per frontier: dedup, merged range reads,
            # span prefetch, per-batch host/device decode placement
            offsets, flat = self._engine.neighbors_batch_ragged(frontier)
            hops += 1
            edges_scanned += int(flat.size)
            if flat.size:
                uniq, first = np.unique(flat, return_index=True)
                fresh = ~np.isin(uniq, visited, assume_unique=True)
                new, first = uniq[fresh], first[fresh]
            else:
                new = np.zeros(0, np.int64)
                first = np.zeros(0, np.int64)
            keep = max_vertices - int(visited.size)
            if new.size > keep:
                new, first = new[:keep], first[:keep]
                truncated = True
            if target is not None and new.size:
                # parent := smallest-id frontier vertex adjacent to the
                # discovery — frontiers are sorted, so the flat stream's
                # first occurrence IS that vertex
                expand_src = np.repeat(frontier, np.diff(offsets))
                for v, j in zip(new, expand_src[first]):
                    parent_of[int(v)] = int(j)
                if bool(np.isin(target, new).item()):
                    found = True
            hop_vertices.append(new)
            hop_depths.append(np.full(new.size, hops, np.int64))
            visited = np.union1d(visited, new)
            frontier = new
        path = None
        if req.kind == "path" and found:
            chain = [target]
            while chain[-1] in parent_of:
                chain.append(parent_of[chain[-1]])
            path = np.asarray(chain[::-1], dtype=np.int64)
        return TraversalResult(
            kind=req.kind,
            vertices=np.concatenate(hop_vertices),
            depths=np.concatenate(hop_depths),
            found=found, path=path, truncated=truncated,
            hops=hops, edges_scanned=edges_scanned)

    # -- admission / accounting primitives ---------------------------------
    # the load generator drives these directly (admission and stats on a
    # virtual timeline); the sync + async paths compose them below
    def admit(self, req: TraversalRequest) -> bool:
        """Offer ``req`` to the gate; accounts submitted/admitted/shed."""
        if self._closed:
            raise ValueError("request on closed service")
        ok = self.gate.try_admit(req.max_edges)
        with self.stats._lock:
            self.stats.submitted += 1
            if ok:
                self.stats.admitted += 1
                self.stats.inflight += 1
            else:
                self.stats.shed += 1
        return ok

    def perform(self, req: TraversalRequest) -> TraversalResult:
        """Run an ADMITTED request's traversal (no release, no latency
        fold — the caller owns the request lifecycle)."""
        try:
            res = self._traverse(req)
        except BaseException:
            self.fail(req)
            raise
        with self.stats._lock:
            st = self.stats
            st.requests_by_kind[req.kind] = \
                st.requests_by_kind.get(req.kind, 0) + 1
            st.frontier_batches += res.hops
            st.edges_scanned += res.edges_scanned
            st.vertices_visited += res.n_visited
            st.truncated += res.truncated
        return res

    def complete(self, req: TraversalRequest, latency_s: float) -> None:
        """Release the gate + fold the request latency into the stats."""
        self.gate.release(req.max_edges)
        with self.stats._lock:
            st = self.stats
            st.completed += 1
            st.inflight -= 1
            st.latencies.add(float(latency_s))

    def fail(self, req: TraversalRequest) -> None:
        """Release an admitted request that errored (clean per-request
        failure: gate tokens return, siblings are untouched)."""
        self.gate.release(req.max_edges)
        with self.stats._lock:
            self.stats.failed += 1
            self.stats.inflight -= 1

    # -- the synchronous path ----------------------------------------------
    def request(self, req: TraversalRequest) -> TraversalResult:
        """Admission-gated synchronous traversal.

        The request ROOT span: every engine gather span, PG-Fuse read
        span and decode span this request causes nests under it, so one
        sampled trace attributes the request's clock time across tiers
        (``repro_torch.obs.report.attribution``).  A shed is a zero-width
        root with one ``shed`` event — sheds stay visible in traces and
        their event count reconciles with ``TraversalStats.shed``.
        """
        with self._tracer.span("traversal.request", tier="request",
                               kind=req.kind) as rsp:
            if not self.admit(req):
                rsp.event("shed", kind=req.kind)
                raise TraversalShed(
                    f"admission gate full "
                    f"({self.gate.inflight} in flight, "
                    f"{self.gate.edges_inflight} edge budget)")
            t0 = self._clock()
            res = self.perform(req)      # fail() runs inside on error
            res.latency_s = self._clock() - t0
            self.complete(req, res.latency_s)
            rsp.set(hops=res.hops, edges=res.edges_scanned,
                    truncated=bool(res.truncated))
            return res

    def khop(self, seeds, k: int, *, max_edges: Optional[int] = None,
             max_vertices: Optional[int] = None) -> TraversalResult:
        """All vertices within ``k`` hops of ``seeds`` (+ depths)."""
        return self.request(TraversalRequest(
            "khop", seeds, k=k,
            max_edges=(max_edges if max_edges is not None
                       else self.default_max_edges),
            max_vertices=max_vertices))

    def bfs_visit(self, seeds, *, max_vertices: Optional[int] = None,
                  max_edges: Optional[int] = None,
                  max_depth: Optional[int] = None) -> TraversalResult:
        """Bounded BFS visit in deterministic order (hop-major,
        ascending id within a hop)."""
        return self.request(TraversalRequest(
            "bfs", seeds, k=max_depth,
            max_edges=(max_edges if max_edges is not None
                       else self.default_max_edges),
            max_vertices=max_vertices))

    def shortest_path(self, source: int, target: int, *,
                      max_edges: Optional[int] = None,
                      max_depth: Optional[int] = None) -> TraversalResult:
        """BFS shortest path; deterministic parents (smallest-id
        adjacent frontier vertex), ``found=False`` when unreachable
        within the budgets."""
        return self.request(TraversalRequest(
            "path", [int(source)], k=max_depth, target=int(target),
            max_edges=(max_edges if max_edges is not None
                       else self.default_max_edges)))

    # -- the async path ----------------------------------------------------
    def submit(self, req: TraversalRequest):
        """Gate in the caller's thread (immediate :class:`TraversalShed`
        on overload), execute on the service's bounded executor; returns
        a ``concurrent.futures.Future`` of :class:`TraversalResult`.
        Each worker thread calls the engine itself, so on the card the
        decode kernel launches from several threads, each on its own
        current CUDA stream (the engine waits for every result before it
        returns)."""
        from concurrent.futures import ThreadPoolExecutor

        if not self.admit(req):
            # zero-width root span so async sheds are trace-visible too
            with self._tracer.span("traversal.request", tier="request",
                                   kind=req.kind) as rsp:
                rsp.event("shed", kind=req.kind)
            raise TraversalShed("admission gate full")
        with self._executor_lock:
            if self._executor is None:
                workers = self.plan.servers if self.plan else 4
                self._executor = ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="traversal-service")
            executor = self._executor

        t0 = self._clock()

        def _run() -> TraversalResult:
            # the root opens in the WORKER thread (spans propagate per
            # thread), covering the executed portion of the request
            with self._tracer.span("traversal.request", tier="request",
                                   kind=req.kind) as rsp:
                res = self.perform(req)  # fail() runs inside on error
                res.latency_s = self._clock() - t0
                self.complete(req, res.latency_s)
                rsp.set(hops=res.hops, edges=res.edges_scanned,
                        truncated=bool(res.truncated))
                return res

        return executor.submit(_run)

    def as_dict(self) -> dict:
        """Service + underlying engine accounting, one dict (plus the
        hot-set tier's, when the backend carries one — a single
        engine's cache or the sharded service's fleet fold)."""
        out = {"traversal": self.stats.as_dict(),
               "query": self._engine.stats.as_dict()}
        hs = None
        if getattr(self._engine, "hotset", None) is not None:
            hs = self._engine.hotset.stats
        elif hasattr(self._engine, "hotset_stats"):
            hs = self._engine.hotset_stats()
        if hs is not None:
            out["hotset"] = hs.as_dict()
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._executor_lock:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None

    def __enter__(self) -> "TraversalService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
