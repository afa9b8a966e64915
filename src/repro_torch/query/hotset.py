"""HBM-resident hot-set cache of DECODED neighbor runs (cache tier 3).

The cache hierarchy below this module ends at host RAM: PG-Fuse keeps
*packed* CompBin bytes resident, so every query — even the thousandth
touch of the same hub vertex — still pays the eq. (1) decode (and, on
the device path, the H2D transfer) per touch.  The zipf traces the
serving benchmarks replay concentrate almost all traffic on a few hub
vertices ("Making Caches Work for Graph Analytics", PAPERS.md:
frequency-clustered hot sets), so the right third tier is obvious: keep
the *decoded* adjacency runs of exactly those hubs resident on the
accelerator, and stop paying decode for them at all.

:class:`HotSetCache` is that tier.  The
:class:`~repro_torch.query.NeighborQueryEngine` consults it FIRST — before the
offsets-run gather — so a hot hit touches neither storage nor the
PG-Fuse block cache, and fills it from whatever each micro-batch decoded
anyway (fills are free: the decode already happened for the caller).

Three mechanisms, all deterministic and injectable-clock friendly:

* **degree-aware admission** (:func:`repro_torch.core.policy.
  choose_hotset_admission`): an entry costs ``8 * degree`` bytes of the
  byte budget, so admission is by degree — the cold tail
  (``degree < min_degree``) BYPASSES the tier entirely (storing a
  3-neighbor run can only evict something hotter), and true hubs
  (``degree >= pin_degree``) are PINNED: the eviction sweep never takes
  them (up to ``pin_fraction`` of the budget), because a hub's
  re-reference is a certainty, not a bet.  Slim Graph (PAPERS.md)
  motivates the same asymmetry: spend the scarce tier on the vertices
  that dominate traffic, let the tail fall through to the cheaper
  tiers;
* **budgeted clock eviction**: the budget is bytes
  (``max_resident_bytes``), mirroring PG-Fuse's
  :class:`~repro_torch.core.pgfuse.EngineShare` arithmetic one tier down;
  over budget, a second-chance sweep walks unpinned entries in
  insertion ring order, clearing reference bits (set on every hit)
  before evicting — a re-touched entry survives one full round of
  churn, exactly PG-Fuse's ``eviction="clock"`` semantics lifted to
  decoded runs;
* **trace-driven prefetch**: the cache observes every batch's unique
  vertex ids (the same per-batch fold that updates
  :class:`~repro_torch.query.QueryStats`) in a bounded frequency window;
  vertices seen ``prefetch_min_hits``+ times that are not yet resident
  become prefetch candidates, and the engine fetches+decodes up to
  ``prefetch_batch`` of them after each request batch — outside the
  batch's latency in ``QueryStats``, though an async caller's future
  resolves only after it — and the next touch of a predicted hub is a
  hit.

Placement: ``place="device"`` keeps each admitted run as an int32
tensor on the cache's ``device`` (ids below ``2^31`` fit the same lanes
the CUDA decode kernel writes;
:func:`~repro_torch.core.policy.choose_hotset_admission` degrades to host
placement beyond that, mirroring
:func:`~repro_torch.core.policy.choose_query_decode`'s constraint), copied
back to an independent int64 host array on every hit (one small tensor
per entry and one device-to-host copy per hit, as the JAX package does)
so hot answers are byte-identical to the host/device/CSR decode paths —
the differential tests assert exactly this.  ``device=None`` means the
GPU and raises when there is none: a device-placed tier never falls back
to host memory by itself; tests pass ``device="cpu"``.  ``place="host"``
keeps plain int64 numpy arrays (the fallback for huge graphs) and never
touches a device.

:class:`HotSetStats` accounts the tier (hits/misses/admissions/
bypasses/evictions/prefetch fills, resident bytes) and merges
associatively like :class:`~repro_torch.query.QueryStats` — the sharded
service folds per-shard hot sets into fleet totals the same way.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import policy as _policy
from repro_torch.kernels.utils import resolve_device

#: byte cost charged to the budget per cached neighbor id (decoded
#: runs are int64 on host; the device copy is int32, but budgeting the
#: wider of the two keeps the budget an upper bound on either placement
#: and ``HotSetStats.resident_bytes`` equal to the JAX package's)
BYTES_PER_EDGE = 8

#: bounded frequency window for trace-driven prefetch: observations
#: older than this many distinct vertices decay away, so the predictor
#: tracks the RECENT hot head, not all-time popularity
HISTORY_WINDOW = 4096


@dataclasses.dataclass
class HotSetStats:
    """Per-cache accounting, shaped like the engine's ``QueryStats``
    (own lock, atomic :meth:`reset`, associative :meth:`merge`).

    Conservation invariants (asserted by ``tests/test_hotset.py``):

    * ``lookups == hits + misses`` (every consulted vertex is one or
      the other);
    * ``fills == admitted + bypassed + rejected`` (every decoded run
      offered to the tier is accounted exactly once).
    """

    lookups: int = 0          # unique vertices consulted (post-dedup)
    hits: int = 0             # answered from the resident tier
    misses: int = 0           # fell through to the storage gather
    fills: int = 0            # decoded runs offered to the tier
    admitted: int = 0         # fills stored (degree >= min_degree, fit)
    bypassed: int = 0         # fills below min_degree (cold tail)
    rejected: int = 0         # admissible fills the budget refused
    evicted: int = 0          # entries the clock sweep revoked
    pinned: int = 0           # CURRENT pinned entries (degree-pinned)
    prefetch_fills: int = 0   # admitted entries that arrived via prefetch
    prefetch_hits: int = 0    # prefetched entries later answered a lookup
                              # (counted once: the first hit clears the
                              # prefetched mark)
    prefetch_evicted: int = 0  # prefetched entries revoked before any hit
    hit_edges: int = 0        # neighbor ids served from the tier
    resident_bytes: int = 0   # CURRENT budget charge
    resident_entries: int = 0  # CURRENT resident vertices

    def __post_init__(self) -> None:
        # attribute, not a field: asdict()/replace() never touch it
        self._lock = threading.Lock()

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    @property
    def conserved(self) -> bool:
        return (self.lookups == self.hits + self.misses
                and self.fills
                == self.admitted + self.bypassed + self.rejected)

    @property
    def prefetch_hit_rate(self) -> float:
        """Fraction of prefetched entries that went on to answer a
        lookup — prefetch effectiveness (gated in the bench lane)."""
        return (self.prefetch_hits / self.prefetch_fills
                if self.prefetch_fills else 0.0)

    def as_dict(self) -> dict:
        with self._lock:
            d = dataclasses.asdict(self)
        d["hit_rate"] = (d["hits"] / d["lookups"] if d["lookups"] else 0.0)
        d["prefetch_hit_rate"] = (d["prefetch_hits"] / d["prefetch_fills"]
                                  if d["prefetch_fills"] else 0.0)
        return d

    def _snapshot(self) -> "HotSetStats":
        with self._lock:
            return dataclasses.replace(self)

    def merge(self, other: "HotSetStats") -> "HotSetStats":
        """Associative cross-cache aggregation (returns a NEW instance)
        — the hot-set sibling of :meth:`repro_torch.query.QueryStats.merge`,
        for folding per-shard hot sets into fleet totals: every field
        (flow counters and resident gauges alike) sums, so per-shard
        sums equal service totals by construction and both conservation
        invariants survive (each is a sum of terms that satisfy them).
        """
        a, b = self._snapshot(), other._snapshot()
        out = HotSetStats()
        for f in dataclasses.fields(out):
            setattr(out, f.name, getattr(a, f.name) + getattr(b, f.name))
        return out

    def reset(self) -> "HotSetStats":
        """Zero the FLOW counters atomically; returns the pre-reset
        snapshot.  Resident gauges (``resident_bytes`` /
        ``resident_entries`` / ``pinned``) describe what is still
        cached, so they survive the cut — the epoch boundary changes
        what has been counted, not what is resident."""
        with self._lock:
            snap = dataclasses.replace(self)
            keep = ("resident_bytes", "resident_entries", "pinned")
            for f in dataclasses.fields(self):
                if f.name not in keep:
                    setattr(self, f.name, 0)
        return snap


def merge_hotset_stats(stats) -> HotSetStats:
    """Fold any number of caches' :class:`HotSetStats` into one
    aggregate (associative; mirrors
    :func:`repro_torch.query.engine.merge_query_stats`)."""
    out = HotSetStats()
    for s in stats:
        out = out.merge(s)
    return out


@dataclasses.dataclass
class _Entry:
    """One resident decoded run."""

    store: object        # int32 tensor or int64 numpy array
    degree: int
    nbytes: int          # budget charge (BYTES_PER_EDGE * degree)
    pinned: bool
    ref: bool = True     # second-chance bit, set on every hit
    prefetched: bool = False  # arrived via prefetch, no lookup hit yet
                              # (outcome lands in prefetch_hits or
                              # prefetch_evicted, exactly once)


class HotSetCache:
    """Device-resident cache of decoded neighbor runs for hub vertices.

    Built from a :class:`repro_torch.core.policy.HotSetPlan` (or the
    equivalent keyword arguments)::

        plan = policy.choose_hotset_admission(
            n_vertices, n_edges, budget_bytes=1 << 22)
        hot = HotSetCache(plan=plan)
        engine = NeighborQueryEngine(graph, hotset=hot)

    Thread-safe: the engine's per-batch ``lookup`` / ``fill`` /
    ``observe`` calls and any concurrent ``stats`` reads serialize on
    one internal lock.  All decisions (admission, eviction order,
    prefetch candidates) are deterministic functions of the call
    sequence — no wall clock, no randomness — so virtual-clock tests
    replay them exactly.

    ``device`` is where a ``place="device"`` plan keeps its runs (None =
    the GPU, raises without one); a host-placed cache ignores it.
    """

    def __init__(self, *, plan: Optional["_policy.HotSetPlan"] = None,
                 budget_bytes: Optional[int] = None,
                 min_degree: Optional[int] = None,
                 pin_degree: Optional[int] = None,
                 pin_fraction: Optional[float] = None,
                 place: Optional[str] = None,
                 prefetch_min_hits: Optional[int] = None,
                 prefetch_batch: Optional[int] = None,
                 device: "torch.device | str | None" = None):
        if plan is None:
            if budget_bytes is None:
                raise ValueError("HotSetCache needs plan= or budget_bytes=")
            plan = _policy.HotSetPlan(
                budget_bytes=int(budget_bytes),
                min_degree=2 if min_degree is None else int(min_degree),
                pin_degree=(1 << 62) if pin_degree is None
                else int(pin_degree),
                pin_fraction=0.5 if pin_fraction is None else pin_fraction,
                place=place or "host",
                prefetch_min_hits=(3 if prefetch_min_hits is None
                                   else int(prefetch_min_hits)),
                prefetch_batch=(8 if prefetch_batch is None
                                else int(prefetch_batch)),
                reason="explicit kwargs")
        else:
            # explicit kwargs override plan fields
            override = dict(budget_bytes=budget_bytes, min_degree=min_degree,
                            pin_degree=pin_degree, pin_fraction=pin_fraction,
                            place=place, prefetch_min_hits=prefetch_min_hits,
                            prefetch_batch=prefetch_batch)
            fields = {k: v for k, v in override.items() if v is not None}
            if fields:
                plan = dataclasses.replace(plan, **fields)
        if plan.budget_bytes < 1:
            raise ValueError(f"budget_bytes must be >= 1, "
                             f"got {plan.budget_bytes}")
        if plan.place not in ("device", "host"):
            raise ValueError(f"place must be 'device' or 'host', "
                             f"got {plan.place!r}")
        if not 0.0 <= plan.pin_fraction <= 1.0:
            raise ValueError(f"pin_fraction must be in [0, 1], "
                             f"got {plan.pin_fraction}")
        self.plan = plan
        # resolved up front so a missing GPU raises at construction
        self._device = (resolve_device(device) if plan.place == "device"
                        else None)
        self.stats = HotSetStats()
        self._lock = threading.Lock()
        self._entries: Dict[int, _Entry] = {}   # insertion order = ring
        self._resident_bytes = 0
        self._pinned_bytes = 0
        self._hand = 0                           # clock hand: ring index
        # trace history for prefetch: bounded per-vertex hit counts over
        # the last HISTORY_WINDOW observations (FIFO decay)
        self._freq: Dict[int, int] = {}
        self._history: List[int] = []
        # candidates already handed out: a prefetched vertex whose run
        # turned out to be cold tail (bypassed) must not be re-fetched
        # every batch; an ADMITTED fill clears the mark, so a later
        # eviction leaves the vertex predictable again
        self._attempted: set = set()

    # -- properties --------------------------------------------------------
    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes

    @property
    def resident_vertices(self) -> np.ndarray:
        """Sorted ids of currently resident vertices (tests/benches)."""
        with self._lock:
            return np.sort(np.fromiter(self._entries, np.int64,
                                       len(self._entries)))

    def is_pinned(self, v: int) -> bool:
        with self._lock:
            e = self._entries.get(int(v))
            return e is not None and e.pinned

    # -- placement ---------------------------------------------------------
    def _place(self, decoded: np.ndarray):
        """Ship one decoded run to its resident representation."""
        if self.plan.place == "device":
            # ids fit int32 by the plan's lane constraint; the device
            # copy is the HBM-resident truth, re-widened on every hit
            return torch.from_numpy(decoded.astype(np.int32)).to(
                self._device)
        return decoded.astype(np.int64, copy=True)

    @staticmethod
    def _fetch(entry: _Entry) -> np.ndarray:
        """An independent int64 host array from the resident store —
        byte-identical to what the decode paths hand out."""
        if isinstance(entry.store, torch.Tensor):
            return entry.store.cpu().numpy().astype(np.int64)
        return np.asarray(entry.store).astype(np.int64)

    # -- the tier API the engine drives ------------------------------------
    def lookup(self, uniq: np.ndarray) -> Dict[int, np.ndarray]:
        """Resident decoded runs for the (unique) ids in ``uniq``.

        Returns ``{vertex_id: int64 ndarray}`` for every hit; ids absent
        from the dict fell through to the storage tier.  Hits set the
        entry's reference bit (second chance) and fold into the
        frequency history alongside misses, so the prefetch predictor
        sees the full trace.
        """
        out: Dict[int, np.ndarray] = {}
        with self._lock:
            st = self.stats
            for v in uniq:
                v = int(v)
                e = self._entries.get(v)
                with st._lock:
                    st.lookups += 1
                    if e is None:
                        st.misses += 1
                        continue
                    st.hits += 1
                    st.hit_edges += e.degree
                    if e.prefetched:
                        # the prefetch paid off; count the outcome once
                        st.prefetch_hits += 1
                e.prefetched = False
                e.ref = True
                out[v] = self._fetch(e)
        return out

    def observe(self, uniq: np.ndarray) -> None:
        """Fold one batch's unique ids into the bounded frequency
        window (the prefetch predictor's input)."""
        with self._lock:
            for v in uniq:
                v = int(v)
                self._freq[v] = self._freq.get(v, 0) + 1
                self._history.append(v)
            while len(self._history) > HISTORY_WINDOW:
                old = self._history.pop(0)
                n = self._freq.get(old, 0) - 1
                if n <= 0:
                    self._freq.pop(old, None)
                else:
                    self._freq[old] = n

    def fill(self, v: int, decoded: np.ndarray, *,
             prefetch: bool = False) -> bool:
        """Offer one decoded run to the tier; returns True if admitted.

        Admission is degree-aware: ``degree < min_degree`` bypasses
        (the cold tail never competes for the budget), ``degree >=
        pin_degree`` pins (up to ``pin_fraction`` of the budget —
        beyond that a hub is admitted unpinned).  Admitting over budget
        triggers the clock sweep; an admissible run the sweep cannot
        make room for (everything else pinned or fresher) is rejected.
        """
        v = int(v)
        degree = int(decoded.size)
        nbytes = BYTES_PER_EDGE * degree
        st = self.stats
        with self._lock:
            with st._lock:
                st.fills += 1
            if v in self._entries:
                # already resident (a racing fill); refresh the ref bit
                self._entries[v].ref = True
                with st._lock:
                    st.admitted += 1
                return True
            if degree < self.plan.min_degree:
                with st._lock:
                    st.bypassed += 1
                return False
            if nbytes > self.plan.budget_bytes:
                with st._lock:
                    st.rejected += 1
                return False
            pinned = (degree >= self.plan.pin_degree
                      and self._pinned_bytes + nbytes
                      <= self.plan.pin_fraction * self.plan.budget_bytes)
            if not self._make_room(nbytes):
                with st._lock:
                    st.rejected += 1
                return False
            self._entries[v] = _Entry(self._place(decoded), degree,
                                      nbytes, pinned, prefetched=prefetch)
            self._resident_bytes += nbytes
            self._attempted.discard(v)
            if pinned:
                self._pinned_bytes += nbytes
            with st._lock:
                st.admitted += 1
                if prefetch:
                    st.prefetch_fills += 1
                st.resident_bytes = self._resident_bytes
                st.resident_entries = len(self._entries)
                st.pinned += pinned
        return True

    def _make_room(self, nbytes: int) -> bool:
        """Clock sweep until ``nbytes`` fits (caller holds the lock).

        Second chance over UNPINNED entries in insertion ring order,
        resuming at the saved hand: the first pass over a referenced
        entry clears its bit, the second evicts.  Returns False when no
        unpinned entry remains to take and the budget still does not
        fit — pinned hubs are never the victims.
        """
        if self._resident_bytes + nbytes <= self.plan.budget_bytes:
            return True
        st = self.stats
        # two full rounds bound the sweep: round one may only clear bits
        max_steps = 2 * len(self._entries) + 2
        steps = 0
        while (self._resident_bytes + nbytes > self.plan.budget_bytes
               and steps < max_steps):
            ring = [u for u, e in self._entries.items() if not e.pinned]
            if not ring:
                return False
            victim = None
            for _ in range(2 * len(ring)):
                u = ring[self._hand % len(ring)]
                self._hand += 1
                steps += 1
                e = self._entries[u]
                if e.ref:
                    e.ref = False     # second chance
                    continue
                victim = u
                break
            if victim is None:
                return False
            e = self._entries.pop(victim)
            self._resident_bytes -= e.nbytes
            with st._lock:
                st.evicted += 1
                if e.prefetched:
                    # revoked before any lookup hit: the prefetch was
                    # wasted budget (the other prefetch outcome)
                    st.prefetch_evicted += 1
                st.resident_bytes = self._resident_bytes
                st.resident_entries = len(self._entries)
        return self._resident_bytes + nbytes <= self.plan.budget_bytes

    # -- trace-driven prefetch ---------------------------------------------
    def prefetch_candidates(self) -> np.ndarray:
        """Up to ``prefetch_batch`` predicted-hot vertex ids to fetch
        next: seen at least ``prefetch_min_hits`` times in the recent
        window, not resident, hottest (then smallest id) first.  The
        engine decodes them through its normal gather core after each
        request batch and offers the runs back via
        ``fill(..., prefetch=True)``.
        """
        with self._lock:
            cand = [(-n, v) for v, n in self._freq.items()
                    if n >= self.plan.prefetch_min_hits
                    and v not in self._entries
                    and v not in self._attempted]
            cand.sort()
            take = [v for _, v in cand[:self.plan.prefetch_batch]]
            self._attempted.update(take)
        return np.asarray(take, dtype=np.int64)

    def clear(self) -> None:
        """Drop every entry (budget returns to zero; stats keep their
        flow history, gauges zero)."""
        with self._lock:
            self._entries.clear()
            self._resident_bytes = 0
            self._pinned_bytes = 0
            self._hand = 0
            self._attempted.clear()
            with self.stats._lock:
                self.stats.resident_bytes = 0
                self.stats.resident_entries = 0
                self.stats.pinned = 0
