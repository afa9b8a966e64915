"""Sharded scatter-gather serving across simulated processes.

A single engine answers every query from ONE process with ONE PG-Fuse mount; the
paper's predecessor ("Selective Parallel Loading of Large-Scale
Compressed Graphs with ParaGrapher") frames loading as an inherently
parallel, partition-per-worker problem, and the serving side scales the
same way.  :class:`ShardedQueryService` is the first step from one
serving process toward that topology:

* **N vertex-range shards** — the graph's edge-balanced partition plan
  is cut by :func:`repro_torch.graph.partition.shard_ranges` (the same
  :func:`~repro_torch.graph.partition.split_plan` slicer the multi-host
  loader uses, ``shares`` skew included) into contiguous per-shard
  ranges; each shard owns its own
  :class:`~repro_torch.query.NeighborQueryEngine` over its OWN
  :class:`~repro_torch.core.paragrapher.GraphHandle` + PG-Fuse mount,
  simulated-process style, as the JAX package's multi-host loader
  simulates hosts — a shard's
  cache only ever holds its range's offset/packed blocks, so per-shard
  working sets shrink by ``1/N`` (the locality lever cache-segmented
  hot sets exploit);
* **routing by vertex range** — a batched ``neighbors`` /
  ``neighbors_batch_ragged`` request splits by ``searchsorted`` over
  the shard range ends, executes as at most ONE engine batch per
  touched shard (dedup/coalescing/span prefetch/device placement all
  still apply per shard), and the per-shard answers are merged back
  into the request's own order — byte-identical to a single engine
  over the whole file;
* **scatter-gather frontiers** — the service exposes the engine's
  query surface, so a :class:`~repro_torch.query.TraversalService` plugs it
  in unchanged: every hop's frontier scatter-gathers across shards
  (one batch per shard per hop) and reassembles into the pinned
  ascending-id order, keeping traversal semantics bit-identical to the
  single-engine service and the in-memory CSR reference (the
  differential harness in ``tests/test_sharded_differential.py``
  asserts exactly this, shard counts 1–4, host and device decode);
* **replication + load-balanced routing** — ``replication=R`` gives
  every shard R replicas (each with its own mount); a shard's slice
  routes to a replica by deterministic round-robin, so hub-heavy zipf
  traffic that concentrates on one shard's range splits across its
  replicas, and a replica whose storage fails over (``OSError``) is
  retried on its siblings (``router.reroutes`` counts the failovers);
* **aggregated accounting** — ``service.stats`` folds every replica's
  :class:`~repro_torch.query.QueryStats` with the associative
  :meth:`~repro_torch.query.QueryStats.merge`, so per-shard sums equal
  service totals by construction (conservation pinned by
  :attr:`ShardedQueryService.conserved`), and the service-level
  :class:`RouterStats` reconciles routed vertex counts against them;
* **per-shard hot sets** — ``hotset_bytes=`` gives every shard replica
  its own HBM-resident :class:`~repro_torch.query.hotset.HotSetCache` above
  its engine (admission sized per shard by
  :func:`repro_torch.core.policy.choose_hotset_admission`); a shard's hot
  set only ever holds ITS range's hubs — the same per-shard locality
  the split cache budgets buy, one tier up — and
  :meth:`ShardedQueryService.hotset_stats` /
  :meth:`~ShardedQueryService.per_shard_hotset_stats` fold the tiers'
  :class:`~repro_torch.query.hotset.HotSetStats` RouterStats-style (per-shard
  sums equal fleet totals by the associative merge).

:func:`repro_torch.core.policy.choose_shard_plan` sizes ``n_shards`` /
``replication`` / ``routing`` from the file size, per-shard cache
budgets and measured trace skew.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core import paragrapher
from repro_torch.core import policy as _policy
from repro_torch.graph.partition import shard_ranges
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.query.engine import NeighborQueryEngine, merge_query_stats


@dataclasses.dataclass
class RouterStats:
    """Service-level routing accounting (one instance per service).

    Conservation — pinned by the differential/fault suites:

    * ``sum(routed_by_shard.values()) == requests`` (every routed
      vertex lands on exactly one shard);
    * ``requests`` equals the merged per-shard engines'
      ``QueryStats.requests`` (nothing answered off the books; a
      failed batch that never folded engine stats is accounted in
      ``failed_batches`` instead).
    """

    requests: int = 0         # vertex lookups routed (duplicates incl.)
    batches: int = 0          # service-level batch calls
    routed_by_shard: dict = dataclasses.field(default_factory=dict)
    shard_batches: dict = dataclasses.field(default_factory=dict)
    reroutes: int = 0         # replica failovers (a sibling answered)
    failed_batches: int = 0   # per-shard batches no replica could answer

    def __post_init__(self) -> None:
        # attribute, not a field: asdict()/replace() never touch it
        self._lock = threading.Lock()

    def as_dict(self) -> dict:
        with self._lock:
            d = {f.name: getattr(self, f.name)
                 for f in dataclasses.fields(self)}
            d["routed_by_shard"] = dict(d["routed_by_shard"])
            d["shard_batches"] = dict(d["shard_batches"])
        return d


@dataclasses.dataclass
class ShardReplica:
    """One shard replica: its own graph handle (own PG-Fuse mount) and
    engine, plus the vertex range the router sends it."""

    shard: int
    replica: int
    graph: "paragrapher.GraphHandle"
    engine: NeighborQueryEngine
    v0: int
    v1: int


class ShardedQueryService:
    """Scatter-gather ``neighbors`` serving over N per-shard engines.

    Drop-in for a single :class:`~repro_torch.query.NeighborQueryEngine`
    wherever only the query surface is used — in particular as the
    frontier-expansion backend of a
    :class:`~repro_torch.query.TraversalService`::

        svc = ShardedQueryService(path, n_shards=2, replication=2)
        trav = TraversalService(svc, admission=plan)

    ``open_kwargs`` / ``engine_kwargs`` are dicts applied to every
    replica, or callables ``(shard, replica) -> dict`` so each
    simulated process gets its own storage backend (benchmarks hand
    every shard its own SimStorage clock this way, exactly like the JAX
    package's ``simulate_hosts`` ``open_kwargs``).  All replicas share one
    card: pass ``engine_kwargs=dict(device=...)`` (None = the GPU, raises
    without one; the tests pass ``"cpu"``), and ``hotset_bytes`` then
    places every replica's tier there too.
    ``plan`` takes a :class:`repro_torch.core.policy.ShardPlan` (explicit
    ``n_shards`` / ``replication`` / ``routing`` override its fields).
    """

    def __init__(self, path, *,
                 n_shards: Optional[int] = None,
                 replication: Optional[int] = None,
                 routing: Optional[str] = None,
                 plan: Optional["_policy.ShardPlan"] = None,
                 shares=None,
                 n_parts: Optional[int] = None,
                 decode: str = "auto",
                 hotset_bytes: Optional[int] = None,
                 open_kwargs=None,
                 engine_kwargs=None,
                 clock: Callable[[], float] = time.perf_counter,
                 tracer=None):
        if plan is not None:
            n_shards = plan.n_shards if n_shards is None else n_shards
            replication = (plan.replication if replication is None
                           else replication)
            routing = plan.routing if routing is None else routing
        n_shards = 1 if n_shards is None else int(n_shards)
        replication = 1 if replication is None else int(replication)
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if replication < 1:
            raise ValueError(f"replication must be >= 1, "
                             f"got {replication}")
        routing = routing or ("rr" if replication > 1 else "direct")
        if routing not in ("direct", "rr"):
            raise ValueError(f"routing must be 'direct' or 'rr', "
                             f"got {routing!r}")
        self.path = path
        self.n_shards = n_shards
        self.replication = replication
        self.routing = routing
        self._clock = clock
        # ONE tracer shared with every replica engine (and, through
        # them, every PG-Fuse mount): nesting is per-thread state on
        # the tracer itself, so the route span below parents the
        # engines' gather spans only when the instances are shared
        self._tracer = tracer if tracer is not None else NULL_TRACER
        # every shard derives the same global plan from the same file —
        # the no-communication property split_plan gives the loader
        with paragrapher.open_graph(path) as g:
            self._n_vertices = g.n_vertices
            gplan = (g.partition_plan(n_parts or max(8, 4 * n_shards))
                     if g.n_vertices else [])
        self.ranges = (shard_ranges(gplan, n_shards, shares=shares)
                       if gplan else [(0, 0)] * n_shards)
        # routing table: shard i covers [bounds[i-1], bounds[i]); empty
        # shards repeat the previous end and are never selected by
        # searchsorted(side="right")
        self._bounds = np.asarray([v1 for _, v1 in self.ranges],
                                  dtype=np.int64)
        amode = _policy.choose_access_mode("serve")
        base_open = dict(use_pgfuse=True, pgfuse_readahead=amode.readahead,
                         pgfuse_eviction=amode.eviction)
        okw = (open_kwargs if callable(open_kwargs)
               else lambda s, r, _d=dict(open_kwargs or {}): _d)
        ekw = (engine_kwargs if callable(engine_kwargs)
               else lambda s, r, _d=dict(engine_kwargs or {}): _d)
        self.replicas: List[List[ShardReplica]] = []
        try:
            for s in range(n_shards):
                row = []
                for r in range(replication):
                    kw = dict(base_open)
                    kw.update(okw(s, r))
                    gh = paragrapher.open_graph(path, **kw)
                    e_kw = dict(ekw(s, r))
                    e_kw.setdefault("decode", decode)
                    e_kw.setdefault("clock", clock)
                    if tracer is not None:
                        e_kw.setdefault("tracer", tracer)
                    if hotset_bytes is not None:
                        # one hot set PER replica: each simulated process
                        # owns its range's hubs, like its PG-Fuse mount
                        e_kw.setdefault("hotset", int(hotset_bytes))
                    eng = NeighborQueryEngine(gh, **e_kw)
                    row.append(ShardReplica(s, r, gh, eng,
                                            *self.ranges[s]))
                self.replicas.append(row)
        except BaseException:
            self._close_replicas()
            raise
        self.router = RouterStats()
        self._rr = [0] * n_shards
        self._rr_lock = threading.Lock()
        self._closed = False

    # -- properties --------------------------------------------------------
    @property
    def n_vertices(self) -> int:
        return self._n_vertices

    @property
    def stats(self):
        """Every replica engine's :class:`~repro_torch.query.QueryStats`
        folded into service totals (a fresh merged snapshot per read —
        per-shard sums equal these totals by associativity)."""
        return merge_query_stats(rep.engine.stats
                                 for row in self.replicas for rep in row)

    def per_shard_stats(self) -> list:
        """One merged :class:`~repro_torch.query.QueryStats` per shard
        (replicas folded)."""
        return [merge_query_stats(rep.engine.stats for rep in row)
                for row in self.replicas]

    def hotset_stats(self):
        """Every replica's :class:`~repro_torch.query.hotset.HotSetStats`
        folded into fleet totals (None when the service runs without a
        hot-set tier)."""
        from repro_torch.query.hotset import merge_hotset_stats

        caches = [rep.engine.hotset for row in self.replicas
                  for rep in row if rep.engine.hotset is not None]
        if not caches:
            return None
        return merge_hotset_stats(c.stats for c in caches)

    def per_shard_hotset_stats(self) -> list:
        """One merged :class:`~repro_torch.query.hotset.HotSetStats` per shard
        (replicas folded; None entries for shards without the tier) —
        the hot-set analogue of ``RouterStats.routed_by_shard``:
        per-shard sums equal :meth:`hotset_stats` totals by the
        associative merge."""
        from repro_torch.query.hotset import merge_hotset_stats

        out = []
        for row in self.replicas:
            caches = [rep.engine.hotset for rep in row
                      if rep.engine.hotset is not None]
            out.append(merge_hotset_stats(c.stats for c in caches)
                       if caches else None)
        return out

    @property
    def conserved(self) -> bool:
        """Routing/stat conservation: routed vertex counts reconcile
        with the merged engine totals, shard by shard and in total."""
        with self.router._lock:
            requests = self.router.requests
            by_shard = dict(self.router.routed_by_shard)
        if sum(by_shard.values()) != requests:
            return False
        per_shard = self.per_shard_stats()
        if sum(st.requests for st in per_shard) != self.stats.requests:
            return False
        return all(per_shard[s].requests == by_shard.get(s, 0)
                   for s in range(self.n_shards))

    def shard_of(self, v: int) -> int:
        """The shard whose vertex range covers ``v``."""
        return int(np.searchsorted(self._bounds, int(v), side="right"))

    # -- routing core ------------------------------------------------------
    def _pick_order(self, s: int) -> List[int]:
        """Replica try-order for one per-shard batch: deterministic
        round-robin start (load-balanced under ``"rr"``), siblings
        following in ring order for failover."""
        row = self.replicas[s]
        if len(row) == 1 or self.routing == "direct":
            return list(range(len(row)))
        with self._rr_lock:
            first = self._rr[s]
            self._rr[s] = (first + 1) % len(row)
        return [(first + k) % len(row) for k in range(len(row))]

    def _shard_batch(self, s: int, subset: np.ndarray) -> List[np.ndarray]:
        """ONE engine batch on shard ``s`` (failing replicas fail over
        to their siblings; only storage-class ``OSError`` reroutes —
        request errors propagate untouched)."""
        row = self.replicas[s]
        last_err: Optional[BaseException] = None
        for k, r in enumerate(self._pick_order(s)):
            try:
                return row[r].engine.neighbors_batch(subset)
            except OSError as e:
                last_err = e
                if k + 1 < len(row):
                    with self.router._lock:
                        self.router.reroutes += 1
                    # lands on the current route span (event count
                    # reconciles with RouterStats.reroutes)
                    self._tracer.event("reroute", shard=s, replica=r)
        with self.router._lock:
            self.router.failed_batches += 1
        self._tracer.event("shard_failed", shard=s)
        raise last_err

    def neighbors_batch(self, vertices) -> List[np.ndarray]:
        """Adjacency lists for ``vertices`` (duplicates fine), in input
        order — byte-identical to one engine over the whole file.  The
        batch splits by vertex range into at most one engine batch per
        touched shard; per-shard answers scatter back to their input
        positions."""
        if self._closed:
            raise ValueError("request on closed service")
        v = np.asarray(vertices, dtype=np.int64).ravel()
        if v.size == 0:
            return []
        if v.min() < 0 or v.max() >= self._n_vertices:
            raise ValueError(
                f"vertex ids must be in [0, {self._n_vertices}); got "
                f"[{v.min()}, {v.max()}]")
        sids = np.searchsorted(self._bounds, v, side="right")
        out: List[Optional[np.ndarray]] = [None] * v.size
        rt = self.router
        with rt._lock:
            rt.batches += 1
        # the route span's SELF time is the scatter/gather machinery;
        # each shard's engine work nests inside as gather/storage/decode
        with self._tracer.span("route.batch", tier="route",
                               vertices=int(v.size),
                               shards=int(np.unique(sids).size)):
            for s in np.unique(sids):
                idx = np.nonzero(sids == s)[0]
                lists = self._shard_batch(int(s), v[idx])
                for i, lst in zip(idx.tolist(), lists):
                    out[i] = lst
                # fold per shard AS each batch lands: a later shard's
                # failure leaves every answered shard's routing and
                # engine counters reconciled (conservation holds
                # mid-failure)
                with rt._lock:
                    s, k = int(s), int(idx.size)
                    rt.requests += k
                    rt.routed_by_shard[s] = rt.routed_by_shard.get(s, 0) + k
                    rt.shard_batches[s] = rt.shard_batches.get(s, 0) + 1
        return out

    def neighbors_batch_ragged(self, vertices) -> tuple:
        """Ragged (CSR-shard) form, same contract as
        :meth:`repro_torch.query.NeighborQueryEngine.neighbors_batch_ragged`:
        a sorted traversal frontier comes back as one flat buffer in
        the same pinned ascending order a single engine produces."""
        lists = self.neighbors_batch(vertices)
        offsets = np.zeros(len(lists) + 1, dtype=np.int64)
        if lists:
            np.cumsum([len(x) for x in lists], out=offsets[1:])
            ids = np.concatenate(lists) if offsets[-1] else \
                np.zeros(0, np.int64)
        else:
            ids = np.zeros(0, np.int64)
        return offsets, ids

    def neighbors_of(self, v: int) -> np.ndarray:
        """Single-vertex convenience (engine-compatible)."""
        return self.neighbors_batch([int(v)])[0]

    # -- lifecycle ---------------------------------------------------------
    def _close_replicas(self) -> None:
        for row in getattr(self, "replicas", []):
            for rep in row:
                try:
                    rep.engine.close()
                finally:
                    rep.graph.close()

    def close(self) -> None:
        if getattr(self, "_closed", True):
            return
        self._closed = True
        self._close_replicas()

    def __enter__(self) -> "ShardedQueryService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
