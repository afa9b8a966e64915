"""Concurrent random-access neighbor-query engine over CompBin + PG-Fuse.

Everything upstream of this module streams the graph *sequentially*; this
is the other half of the paper's CompBin claim (§IV): the packed
neighbors array is **byte-addressable** — the n-th neighbor of vertex
``v`` lives at ``neighbors_start + (offsets[v] + n) * b`` — so any
adjacency list can be fetched in O(1) reads with no sequential decode.
The engine turns that property into a serving-grade query path:

* a **batch** of vertex ids is deduplicated, its offset pairs and packed
  neighbor ranges are **coalesced** into merged range reads (two vertices
  whose bytes share a PG-Fuse block cost one request, not two), and the
  packed bytes are decoded with eq. (1)'s shift+adds;
* the packed bytes of a **large-fanout batch decode on the device**:
  the merged runs ship in ONE host-to-device copy and the CUDA
  ``compbin_decode`` kernel runs eq. (1) next to the gathers it feeds —
  host and device modes are bit-identical, and
  :func:`repro_torch.core.policy.choose_query_decode` places each micro-batch
  by its exact edge mass (known after the offsets gather, before any
  byte is decoded);
* an **async request queue** micro-batches concurrent callers: requests
  arriving within ``window_s`` (or until ``max_batch`` ids are pending)
  execute as ONE coalesced batch, and the **adaptive window**
  (:class:`repro_torch.query.window.AdaptiveWindow`) closes the batch EARLY
  the moment the pending dedup ratio stops improving — waiting only
  pays while concurrent traffic overlaps;
* an optional **device-resident hot-set tier**
  (:class:`repro_torch.query.hotset.HotSetCache`, ``hotset=``) sits ABOVE
  the gather: decoded neighbor runs of hub vertices stay resident on the
  card under a byte budget with degree-aware admission
  (:func:`repro_torch.core.policy.choose_hotset_admission` — pin hubs,
  bypass the cold tail), so a hot hit touches neither storage nor the
  PG-Fuse block cache nor the decoder, and trace-driven prefetch fetches
  predicted-hot vertices after each batch (outside the batch's latency
  in :class:`QueryStats`, but before the batch's futures resolve) — hot
  answers are byte-identical to every decode path (the differential
  tests assert it);
* :class:`QueryStats` accounts every request: virtual-clock latency
  percentiles (p50/p99 under an injectable ``clock``, so benchmarks
  measure the *request pattern* against a simulated storage clock, not
  the CI machine), unique PG-Fuse blocks touched, and the dedup ratio
  (requested ids / unique ids actually fetched).

PG-Fuse should be mounted in the **random-access mode**
(:func:`repro_torch.core.policy.choose_access_mode`): readahead off — the next
sequential block is NOT more likely to be needed — and clock/second-
chance eviction so the hot offset blocks survive packed-byte churn.

Device rule: ``device=None`` means the GPU and raises when there is
none, unless the engine is pinned to ``decode="host"`` (it then never
touches a device for decoding); tests pass ``device="cpu"``.  A hot set
built here from a byte budget or a plan gets the same ``device`` — a
device-placed tier goes to the GPU whatever the decode mode (as in the
JAX package), so under ``decode="host"`` with ``device=None`` it raises
without one.

The full three-tier hierarchy (storage blocks / host-RAM PG-Fuse / HBM
hot set) is laid out in ``docs/architecture.md``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import codec as _codec
from repro_torch.core import compbin
from repro_torch.core import policy as _policy
from repro_torch.core.paragrapher import GraphHandle
from repro_torch.kernels.utils import resolve_device
from repro_torch.obs.metrics import LatencyHistogram
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.query.window import AdaptiveWindow

DECODE_MODES = ("host", "device", "auto")


def _merge_ranges(ranges: List[tuple], gap: int) -> List[tuple]:
    """Merge byte ranges whose gap is <= ``gap`` into covering reads.

    ``ranges`` are (start, end) with end exclusive; the result is sorted
    and disjoint.  Merging across a small gap trades a bounded memcpy of
    unneeded bytes for one fewer cache request — on PG-Fuse the gap bytes
    are in already-acquired blocks, so no extra storage traffic occurs.
    """
    if not ranges:
        return []
    ranges = sorted(ranges)
    out = [list(ranges[0])]
    for s, e in ranges[1:]:
        if s - out[-1][1] <= gap:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _blocks_of(ranges: Sequence[tuple], block_size: int) -> set:
    """Unique block indices addressed by byte ``ranges``."""
    touched = set()
    for s, e in ranges:
        if e > s:
            touched.update(range(s // block_size, (e - 1) // block_size + 1))
    return touched


@dataclasses.dataclass
class QueryStats:
    """Per-engine accounting (reset with :meth:`reset`).

    ``latencies`` is a fixed-size log-bucket
    :class:`repro_torch.obs.metrics.LatencyHistogram` over the engine's WHOLE
    history — bounded memory with no rolling-window truncation, and its
    merge is exactly associative (the old raw-list retention grew
    without bound and ``merge()`` concatenated untrimmed).  p50/p99 are
    within one bucket width (~2%) of the exact values, exact for
    constant (virtual-clock) distributions.
    """

    requests: int = 0          # vertex lookups requested (duplicates incl.)
    unique_vertices: int = 0   # fetched after in-batch dedup
    batches: int = 0           # coalesced executions
    coalesced_reads: int = 0   # merged range reads issued (offsets+packed)
    blocks_touched: int = 0    # unique cache blocks addressed (per batch)
    bytes_gathered: int = 0    # packed+offset bytes actually needed
    edges_returned: int = 0    # neighbor ids handed back to callers
    device_batches: int = 0    # micro-batches decoded on device
    bytes_h2d: int = 0         # packed bytes shipped for device decode
    # why each executed batch closed ("full"/"plateau"/"timeout"/"flush"/
    # "direct"); invariant: sum(close_reasons.values()) == batches —
    # held at EVERY instant, including snapshots taken concurrently
    # with in-flight batches, because every mutation (the engine's
    # per-batch fold, reset) runs under this object's _lock
    close_reasons: dict = dataclasses.field(default_factory=dict)
    latencies: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)

    def __post_init__(self) -> None:
        # the stats object OWNS its lock (an attribute, not a field, so
        # asdict()/replace() never touch it): the engine folds each
        # batch under it, and reset()/as_dict() take the SAME lock —
        # a reset interleaving a fold mid-batch used to tear the
        # close_reasons/batches invariant
        self._lock = threading.Lock()

    @property
    def dedup_ratio(self) -> float:
        """Requested ids per unique fetch (> 1 when batching pays)."""
        return self.requests / self.unique_vertices \
            if self.unique_vertices else 0.0

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
            d["close_reasons"] = dict(d["close_reasons"])
            hist = d.pop("latencies")
            d["n_latencies"] = hist.n
            d["p50_s"] = hist.quantile(0.50)
            d["p99_s"] = hist.quantile(0.99)
        d["dedup_ratio"] = (d["requests"] / d["unique_vertices"]
                            if d["unique_vertices"] else 0.0)
        return d

    def _snapshot(self) -> "QueryStats":
        """A consistent copy taken under the stats lock (mutable fields
        deep-copied, so the snapshot never aliases live state)."""
        with self._lock:
            return dataclasses.replace(
                self, latencies=self.latencies.copy(),
                close_reasons=dict(self.close_reasons))

    def merge(self, other: "QueryStats") -> "QueryStats":
        """Associative cross-engine aggregation (returns a NEW instance).

        The sharded service (:mod:`repro_torch.query.sharded`) folds every
        shard replica's engine stats into service totals with this:
        counters sum, ``close_reasons`` sum key-wise, latency
        histograms merge bucket-wise (exactly associative, so
        per-shard sums equal service totals).  Each side is snapshotted
        under its own lock — no lock ordering between the two objects,
        so merging is safe against concurrent folds AND against
        ``merge(self, self)``.  The invariant
        ``sum(close_reasons.values()) == batches`` is preserved: it
        holds for each operand, and both sides sum.
        """
        a, b = self._snapshot(), other._snapshot()
        out = QueryStats()
        for f in dataclasses.fields(out):
            if f.name in ("latencies", "close_reasons"):
                continue
            setattr(out, f.name, getattr(a, f.name) + getattr(b, f.name))
        for src in (a.close_reasons, b.close_reasons):
            for k, v in src.items():
                out.close_reasons[k] = out.close_reasons.get(k, 0) + v
        out.latencies = a.latencies.merge(b.latencies)
        return out

    def reset(self) -> "QueryStats":
        """Zero in place ATOMICALLY; returns the pre-reset snapshot.

        Runs under the stats lock, so concurrent in-flight batches
        land wholly before or wholly after the cut: the snapshot and
        the zeroed object BOTH satisfy
        ``sum(close_reasons.values()) == batches``, and no batch is
        lost across the reset (the regression suite hammers exactly
        this interleaving).
        """
        with self._lock:
            snap = dataclasses.replace(
                self, latencies=self.latencies.copy(),
                close_reasons=dict(self.close_reasons))
            for f in dataclasses.fields(self):
                cur = getattr(self, f.name)
                setattr(self, f.name,
                        LatencyHistogram()
                        if isinstance(cur, LatencyHistogram)
                        else [] if isinstance(cur, list)
                        else {} if isinstance(cur, dict) else 0)
        return snap


def merge_query_stats(stats) -> QueryStats:
    """Fold any number of engines' :class:`QueryStats` into one
    aggregate (associative; mirrors
    :func:`repro_torch.data.graph_stream.merge_stats`)."""
    out = QueryStats()
    for s in stats:
        out = out.merge(s)
    return out


class QueryFuture:
    """Result slot for one async request (resolved by the engine)."""

    def __init__(self, vertices: np.ndarray, t_submit: float):
        self.vertices = vertices
        self.t_submit = t_submit
        self._done = threading.Event()
        self._result: Optional[List[np.ndarray]] = None
        self._error: Optional[BaseException] = None
        self.latency_s: float = 0.0

    def _resolve(self, result, error, latency_s: float) -> None:
        self._result = result
        self._error = error
        self.latency_s = latency_s
        self._done.set()

    def result(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        if not self._done.wait(timeout):
            raise TimeoutError("query did not complete in time")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def done(self) -> bool:
        return self._done.is_set()


class NeighborQueryEngine:
    """Batched random-access ``neighbors(v)`` over an open CompBin graph.

    One engine per host; the graph handle's PG-Fuse mount is shared with
    whatever else the host serves (feature stores mount into the same
    budget).  Synchronous use::

        engine = NeighborQueryEngine(graph)
        adj = engine.neighbors_batch([5, 9, 5, 1022])   # list of arrays

    Concurrent serving::

        fut = engine.submit(request_vertex_ids)          # any thread
        neighbor_lists = fut.result()

    ``clock`` injects the time source for latency stats — benchmarks pass
    a SimStorage virtual clock so p50/p99 are deterministic properties of
    the request pattern.
    """

    def __init__(self, graph: GraphHandle, *,
                 max_batch: int = 1024,
                 window_s: float = 0.002,
                 merge_gap: Optional[int] = None,
                 decode: str = "auto",
                 adaptive_window: bool = True,
                 window_patience: int = 2,
                 window_min_overlap: float = 0.05,
                 hotset=None,
                 clock: Callable[[], float] = time.perf_counter,
                 tracer=None,
                 device: "torch.device | str | None" = None):
        if not _codec.get_codec(graph.format).direct:
            raise ValueError(
                f"random-access queries need a direct-addressing codec "
                f"({', '.join(_codec.direct_codecs())}), not "
                f"{graph.format!r} (WebGraph requires a sequential decode "
                f"per block of vertices)")
        if decode not in DECODE_MODES:
            raise ValueError(f"decode must be one of {DECODE_MODES}, "
                             f"got {decode!r}")
        if decode == "device" and graph.n_vertices > (1 << 31):
            raise ValueError(
                f"|V|={graph.n_vertices} overflows the kernel's int32 "
                f"lanes; use decode='host' (or 'auto', which routes there)")
        self._graph = graph
        self._clock = clock
        # where device batches decode: resolved up front so a missing GPU
        # raises at construction, not in the middle of serving
        self._device = None if decode == "host" else resolve_device(device)
        # span tracing (repro_torch.obs): the default NULL_TRACER makes every
        # span site a no-op context manager — zero-cost when disabled.
        # A real tracer is also handed to this engine's PG-Fuse mount so
        # storage reads nest under this engine's gather spans.
        self._tracer = tracer if tracer is not None else NULL_TRACER
        if tracer is not None and graph.fs is not None:
            graph.fs.tracer = tracer
        self.decode = decode
        self.max_batch = int(max_batch)
        self.window_s = float(window_s)
        # header fields pin the direct-addressing arithmetic
        rdr = graph._reader()
        try:
            self._header = rdr.header
        finally:
            rdr.close()
        self._b = self._header.b
        self._block_size = (graph.fs.block_size if graph.fs is not None
                            else 1 << 20)
        self.merge_gap = (int(merge_gap) if merge_gap is not None
                          else self._block_size)
        # the optional HBM-resident tier above the gather: an int is a
        # byte budget (admission sized by policy from THIS graph's mean
        # degree), a HotSetCache/HotSetPlan is used as given; a tier built
        # here places its runs on ``device`` (None = the GPU)
        self._hotset = None
        if hotset is not None:
            from repro_torch.query.hotset import HotSetCache
            if isinstance(hotset, HotSetCache):
                self._hotset = hotset
            elif isinstance(hotset, _policy.HotSetPlan):
                self._hotset = HotSetCache(plan=hotset, device=device)
            else:
                plan = _policy.choose_hotset_admission(
                    graph.n_vertices, self._header.n_edges, int(hotset))
                self._hotset = HotSetCache(plan=plan, device=device)
        self.stats = QueryStats()
        # per-batch folds share the stats object's OWN lock, so an
        # external stats.reset()/as_dict() is atomic against them
        self._stats_lock = self.stats._lock
        # async micro-batching state: _have_work wakes the idle worker
        # (it blocks indefinitely between requests — no polling);
        # _full short-circuits the batching window when max_batch ids
        # are already pending
        self._pending: List[QueryFuture] = []
        self._pending_lock = threading.Lock()
        self._have_work = threading.Event()
        self._full = threading.Event()
        # the window decides WHEN the pending batch executes; its clock is
        # the engine's, so benches/tests drive it virtually
        self._window = AdaptiveWindow(
            window_s=self.window_s, max_batch=self.max_batch,
            adaptive=adaptive_window, patience=window_patience,
            min_overlap=window_min_overlap, clock=clock)
        self._close_reason: Optional[str] = None
        self._closed = False
        self._worker: Optional[threading.Thread] = None

    # -- properties --------------------------------------------------------
    @property
    def n_vertices(self) -> int:
        return self._graph.n_vertices

    @property
    def graph(self) -> GraphHandle:
        return self._graph

    @property
    def hotset(self):
        """The device-resident hot-set tier, or None (see
        :mod:`repro_torch.query.hotset`)."""
        return self._hotset

    # -- the coalesced fetch core ------------------------------------------
    @staticmethod
    def _read_range(f, start: int, nbytes: int) -> bytes:
        """One merged range read.  Over PG-Fuse the span is announced
        first (``prefetch_range``): every cold run of blocks it covers is
        fetched with ONE enlarged storage request instead of one request
        per block — random-access traffic then gets the paper's
        fewer-larger-requests property without speculative readahead."""
        if hasattr(f, "prefetch_range"):
            f.prefetch_range(start, nbytes)
        if hasattr(f, "pread"):
            return f.pread(start, nbytes)
        f.seek(start)
        return f.read(nbytes)

    def _gather_offsets(self, uniq: np.ndarray, f):
        """offsets[v] and offsets[v+1] for each (sorted unique) vertex,
        via coalesced range reads of the offsets array.

        Returns (int64 array of shape (len(uniq), 2), n_reads, byte
        ranges read).  Consecutive vertices share the boundary entry;
        runs closer than the merge gap collapse into one read.  All the
        codec-specific addressing lives in the header's contract methods
        (``offsets_span`` / ``decode_offsets`` / ``offsets_gap_vertices``
        — see :mod:`repro_torch.core.codec`), so CompBin's plain u64 array and
        LogCSR's bit-packed one take the same path here.
        """
        h = self._header
        with self._tracer.span("query.offsets", tier="gather") as sp:
            gap_vertices = h.offsets_gap_vertices(self.merge_gap)
            runs: List[tuple] = []   # (v_start, v_end) inclusive vertex runs
            for v in uniq:
                v = int(v)
                if runs and v - runs[-1][1] <= gap_vertices:
                    runs[-1] = (runs[-1][0], v)
                else:
                    runs.append((v, v))
            out = np.empty((len(uniq), 2), dtype=np.int64)
            byte_ranges = []
            i = 0
            for a, z in runs:
                start, nbytes = h.offsets_span(a, z)   # offsets[a ..= z+1]
                raw = self._read_range(f, start, nbytes)
                words = h.decode_offsets(raw, a, z)
                byte_ranges.append((start, start + nbytes))
                while i < len(uniq) and a <= int(uniq[i]) <= z:
                    lo = int(uniq[i]) - a
                    out[i, 0] = words[lo]
                    out[i, 1] = words[lo + 1]
                    i += 1
            assert i == len(uniq)
            sp.set(reads=len(runs))
        return out, len(runs), byte_ranges

    def _gather_packed(self, spans: np.ndarray, f):
        """Packed neighbor bytes for each (o0, o1) edge span, via merged
        range reads of the neighbors section.  Returns (list of per-span
        uint8 arrays, n_reads, needed byte ranges)."""
        h = self._header
        b = self._b
        with self._tracer.span("query.packed", tier="gather") as sp:
            need = []
            for k, (o0, o1) in enumerate(spans):
                if o1 > o0:
                    s = h.neighbors_start + b * int(o0)
                    need.append((s, s + b * int(o1 - o0), k))
            merged = _merge_ranges([(s, e) for s, e, _ in need],
                                   self.merge_gap)
            bufs = {}
            for s, e in merged:
                raw = self._read_range(f, s, e - s)
                bufs[s] = (np.frombuffer(raw, dtype=np.uint8), e)
            starts = sorted(bufs)
            out: List[np.ndarray] = [np.zeros(0, np.uint8)] * len(spans)
            for s, e, k in need:
                # merged run containing this span
                j = int(np.searchsorted(starts, s, side="right")) - 1
                base = starts[j]
                buf, _ = bufs[base]
                out[k] = buf[s - base: e - base]
            sp.set(reads=len(merged))
        return out, len(merged), [(s, e) for s, e, _ in need]

    def _open(self):
        """A positional-read handle: the PG-Fuse CachedFile when mounted
        (its ``pread`` assembles from cached blocks), else a plain file."""
        if self._graph.fs is not None:
            return self._graph.fs.mount(self._graph.path), False
        return open(self._graph.path, "rb"), True

    # -- decode placement (the tentpole of serving-path v2) ----------------
    def _decode_plan(self, n_edges: int) -> "_policy.QueryDecodePlan":
        """Host-vs-device placement for ONE micro-batch of ``n_edges``."""
        if self.decode == "host":
            return _policy.QueryDecodePlan("host", "engine pinned to host")
        if self.decode == "device":
            return _policy.QueryDecodePlan("device", "engine pinned to device")
        return _policy.choose_query_decode(n_edges, self._b,
                                           n_vertices=self.n_vertices)

    def _decode_host(self, packed: List[np.ndarray]
                     ) -> tuple[List[np.ndarray], int]:
        """Eq. (1) on the host, one span at a time.  Returns (decoded
        int64 arrays, 0 bytes shipped)."""
        return [compbin.decode_ids(p, self._b).astype(np.int64)
                for p in packed], 0

    def _decode_device(self, packed: List[np.ndarray]
                       ) -> tuple[List[np.ndarray], int]:
        """Eq. (1) on the device: the batch's merged packed runs ship as
        ONE transfer, the CUDA kernel decodes them, and the flat id
        stream is split back into per-span views — bit-identical to
        :meth:`_decode_host`.  The decoder is resolved per codec through
        the kernel op surface's registry (LogCSR shares CompBin's packed
        neighbor layout, hence its kernel).  Returns (decoded arrays,
        H2D bytes)."""
        from repro_torch.kernels.compbin_decode import packed_stream_decoder

        if not packed:
            return [], 0
        lens = np.array([p.size // self._b for p in packed], dtype=np.int64)
        if int(lens.sum()) == 0:
            return [np.zeros(0, np.int64) for _ in packed], 0
        allbytes = np.concatenate(packed)
        decode_stream = packed_stream_decoder(self._graph.format)
        ids, nbytes_h2d = decode_stream(allbytes, self._b,
                                        device=self._device)
        # per-span COPIES, matching the host path's independent arrays:
        # handing out views into the flat batch buffer would let one
        # retained hub list pin the whole batch's decoded ids
        return [a.copy() for a in np.split(ids, np.cumsum(lens)[:-1])], \
            nbytes_h2d

    def neighbors_batch(self, vertices, *, _close_reason: str = "direct",
                        _t_submit: Sequence[float] = ()
                        ) -> List[np.ndarray]:
        """Adjacency lists for ``vertices`` (duplicates fine), in order.

        The whole batch is deduplicated and fetched with coalesced reads;
        each returned array is the full (decoded) neighbor list of the
        corresponding input vertex.  ``_close_reason`` is the engine's
        internal accounting of WHY this batch executed (the async worker
        passes the window-close reason; direct calls record "direct"),
        ``_t_submit`` the engine-clock submit times of the requests the
        batch serves (the span's ``queued_s``).
        """
        vertices = np.asarray(vertices, dtype=np.int64).ravel()
        if vertices.size == 0:
            return []
        if vertices.min() < 0 or vertices.max() >= self.n_vertices:
            raise ValueError(
                f"vertex ids must be in [0, {self.n_vertices}); got "
                f"[{vertices.min()}, {vertices.max()}]")
        t0 = self._clock()
        tracer = self._tracer
        # the gather span covers the whole coalesced fetch: its fetch and
        # hot-set children share its tier, the PG-Fuse read spans
        # (tier=storage) and the decode span nest inside, so its SELF
        # time is the dedup, scatter and result assembly
        with tracer.span("query.batch", tier="gather",
                         vertices=int(vertices.size),
                         queued_s=[t0 - t for t in _t_submit]) as bsp:
            uniq, inverse = np.unique(vertices, return_inverse=True)
            # tier-3 lookup FIRST: a hot vertex touches neither storage
            # nor the PG-Fuse block cache nor the decoder below
            hot: dict = {}
            if self._hotset is not None:
                with tracer.span("query.hotset.lookup",
                                 tier="gather") as hsp:
                    hot = self._hotset.lookup(uniq)
                    hsp.set(hits=len(hot), misses=int(len(uniq) - len(hot)),
                            copies=len(hot) if self._hotset.plan.place
                            == "device" else 0)
                with tracer.span("query.hotset.observe", tier="gather"):
                    self._hotset.observe(uniq)
            if hot:
                cold = uniq[np.fromiter((int(v) not in hot for v in uniq),
                                        bool, len(uniq))]
            else:
                cold = uniq
            off_reads = nbr_reads = 0
            off_ranges: List[tuple] = []
            nbr_ranges: List[tuple] = []
            decoded_cold: List[np.ndarray] = []
            bytes_h2d = 0
            on_device = 0
            if cold.size:
                f, own = self._open()
                try:
                    spans, off_reads, off_ranges = \
                        self._gather_offsets(cold, f)
                    packed, nbr_reads, nbr_ranges = \
                        self._gather_packed(spans, f)
                finally:
                    if own:
                        f.close()
                # placement per batch: edge mass is exact here (offsets
                # gathered, nothing decoded yet)
                n_edges = int((spans[:, 1] - spans[:, 0]).sum()) \
                    if len(spans) else 0
                plan = self._decode_plan(n_edges)
                decode = self._decode_device if plan.device \
                    else self._decode_host
                with tracer.span("query.decode", tier="decode",
                                 mode="device" if plan.device else "host",
                                 edges=n_edges) as dsp:
                    decoded_cold, bytes_h2d = decode(packed)
                    dsp.set(bytes_h2d=int(bytes_h2d))
                on_device = int(plan.device)
            if self._hotset is not None:
                # fills are free for the caller: the decode already
                # happened (admission keeps the cold tail out — see
                # hotset.fill)
                self._hotset_fill(cold, decoded_cold)
            if hot:
                it = iter(decoded_cold)
                decoded = [hot[int(v)] if int(v) in hot else next(it)
                           for v in uniq]
            else:
                decoded = decoded_cold
            result = [decoded[j] for j in inverse]
            latency = self._clock() - t0
            touched = _blocks_of(off_ranges + nbr_ranges, self._block_size)
            with self._stats_lock:
                st = self.stats
                st.requests += len(vertices)
                st.unique_vertices += len(uniq)
                st.batches += 1
                st.coalesced_reads += off_reads + nbr_reads
                st.blocks_touched += len(touched)
                st.bytes_gathered += sum(e - s
                                         for s, e in off_ranges + nbr_ranges)
                st.edges_returned += sum(len(d) for d in result)
                st.device_batches += on_device
                st.bytes_h2d += bytes_h2d
                st.close_reasons[_close_reason] = \
                    st.close_reasons.get(_close_reason, 0) + 1
                st.latencies.add(latency)
            bsp.event("window_close", reason=_close_reason)
        if self._hotset is not None:
            # trace-driven prefetch after the batch's latency is folded:
            # the engine's stats leave it out, but an async caller waits
            # for it too (``_execute`` resolves the futures only when
            # this call returns)
            self._hotset_prefetch()
        return result

    def _hotset_fill(self, vs: np.ndarray, decoded: List[np.ndarray], *,
                     prefetch: bool = False) -> None:
        """Offer decoded runs to the hot-set tier, in one span whose
        attributes are the tier's counter deltas (and the host-to-device
        copies of the runs it placed on the device)."""
        st = self._hotset.stats
        with self._tracer.span("query.hotset.fill", tier="gather") as sp:
            with st._lock:
                a0, e0, r0 = st.admitted, st.evicted, st.resident_entries
            for v, d in zip(vs, decoded):
                self._hotset.fill(int(v), d, prefetch=prefetch)
            with st._lock:
                a1, e1, r1 = st.admitted, st.evicted, st.resident_entries
            # every entry placed is either still resident or evicted since
            placed = (r1 - r0) + (e1 - e0)
            sp.set(offered=len(decoded), admitted=a1 - a0, evicted=e1 - e0,
                   copies=placed if self._hotset.plan.place == "device"
                   else 0)

    def _hotset_prefetch(self) -> None:
        """Fetch + decode the tier's predicted-hot candidates and offer
        them back as prefetch fills.  Runs the same gather core as the
        request path (merged ranges, span announcement) but folds into
        :class:`~repro_torch.query.hotset.HotSetStats` only — prefetch is the
        tier warming itself, not request traffic."""
        cand = np.sort(self._hotset.prefetch_candidates())
        if cand.size == 0:
            return
        # own span (tier=gather so a direct engine call may root here):
        # prefetch time is the tier warming itself, deliberately OUTSIDE
        # the request's query.batch span
        with self._tracer.span("query.prefetch", tier="gather",
                               candidates=int(cand.size)):
            f, own = self._open()
            try:
                spans, _, _ = self._gather_offsets(cand, f)
                packed, _, _ = self._gather_packed(spans, f)
            finally:
                if own:
                    f.close()
            with self._tracer.span("query.decode", tier="decode",
                                   mode="host"):
                decoded, _ = self._decode_host(packed)
            self._hotset_fill(cand, decoded, prefetch=True)

    def neighbors_batch_ragged(self, vertices) -> tuple:
        """Ragged (CSR-shard) form of :meth:`neighbors_batch`: returns
        ``(offsets, ids)`` where ``ids[offsets[i]:offsets[i+1]]`` is the
        neighbor list of ``vertices[i]`` — one flat buffer + offsets for
        consumers that ship the whole frontier onward (e.g. straight
        into a device gather) instead of a Python list per vertex."""
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
        """Single-vertex convenience (GraphHandle-compatible)."""
        return self.neighbors_batch([int(v)])[0]

    # -- async micro-batching ----------------------------------------------
    def submit(self, vertices) -> QueryFuture:
        """Enqueue a request; it executes in the next micro-batch.

        Requests arriving within ``window_s`` of each other (or until
        ``max_batch`` ids are pending) are coalesced into ONE deduplicated
        fetch — the dedup ratio then counts cross-request sharing too.
        The adaptive window additionally closes the batch EARLY when the
        pending dedup ratio stops improving (waiting only pays while
        concurrent traffic overlaps); every executed batch's close reason
        lands in ``stats.close_reasons``.
        """
        if self._closed:
            raise ValueError("submit on closed engine")
        vertices = np.asarray(vertices, dtype=np.int64).ravel()
        fut = QueryFuture(vertices, self._clock())
        with self._pending_lock:
            self._pending.append(fut)
            reason = self._window.arrival(vertices)
            if reason is not None and self._close_reason is None:
                self._close_reason = reason
            close_now = self._close_reason is not None
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._worker_loop, daemon=True,
                    name="neighbor-query-engine")
                self._worker.start()
        self._have_work.set()
        if close_now:
            self._full.set()
        return fut

    def _take_pending(self, default_reason: str = "flush"
                      ) -> tuple[List[QueryFuture], str]:
        with self._pending_lock:
            batch, self._pending = self._pending, []
            reason = self._close_reason or default_reason
            self._close_reason = None
            self._window.reset()
        return batch, reason

    def _execute(self, batch: List[QueryFuture],
                 reason: str = "flush") -> None:
        if not batch:
            return
        splits = np.cumsum([f.vertices.size for f in batch])[:-1]
        allv = np.concatenate([f.vertices for f in batch]) \
            if batch else np.zeros(0, np.int64)
        try:
            results = self.neighbors_batch(
                allv, _close_reason=reason,
                _t_submit=[f.t_submit for f in batch])
            per_req = [results[a:b] for a, b in
                       zip([0, *splits], [*splits, len(results)])]
            now = self._clock()
            for f, r in zip(batch, per_req):
                f._resolve(r, None, now - f.t_submit)
        except BaseException as e:
            now = self._clock()
            for f in batch:
                f._resolve(None, e, now - f.t_submit)

    def _worker_loop(self) -> None:
        while not self._closed:
            self._have_work.wait()   # idle: block, never poll
            if self._closed:
                return
            # the micro-batch window: give concurrent callers window_s
            # (REAL time — the engine's injectable clock may be virtual,
            # and an Event.wait timeout must not come from it) to pile
            # on; the window (via submit) cuts the wait short on "full"
            # or "plateau", a wait that expires untriggered is "timeout"
            self._full.wait(timeout=self.window_s)
            self._full.clear()
            self._have_work.clear()  # a submit racing past here re-sets it
            self._execute(*self._take_pending("timeout"))

    def flush(self) -> None:
        """Execute everything pending right now (on the calling thread)."""
        self._execute(*self._take_pending("flush"))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._have_work.set()  # unblock the idle worker so it can exit
        self._full.set()
        if self._worker is not None:
            self._worker.join(timeout=5)
        self.flush()  # resolve stragglers rather than hanging callers

    def __enter__(self) -> "NeighborQueryEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def gather_rows(store, ids) -> np.ndarray:
    """Feature rows for ``ids`` (duplicates fine) from a feature-store
    handle (:class:`repro_torch.core.featstore.FeatureStoreHandle`, or
    anything with its ``n_rows``, ``d``, ``dtype``, ``header.row_stride``
    and ``read_rows``), with run-coalesced
    reads: sorted unique ids collapse into contiguous ``read_rows`` calls
    wherever the gap is small, so a clustered id batch costs a handful of
    range reads instead of one per row.
    """
    ids = np.asarray(ids, dtype=np.int64).ravel()
    out = np.zeros((len(ids), store.d), dtype=store.dtype)
    valid = ids >= 0   # sampler padding (-1) gathers zero rows
    if not valid.any():
        return out
    uniq, inverse = np.unique(ids[valid], return_inverse=True)
    if uniq.min() < 0 or uniq.max() >= store.n_rows:
        raise ValueError(f"row ids must be in [0, {store.n_rows})")
    # rows closer than ~64 KiB collapse into one range read: the gap rows
    # come out of blocks the run already acquired
    gap = max(1, (1 << 16) // max(1, store.header.row_stride))
    rows = np.empty((len(uniq), store.d), dtype=store.dtype)
    i = 0
    while i < len(uniq):
        j = i
        while j + 1 < len(uniq) and int(uniq[j + 1]) - int(uniq[j]) <= gap:
            j += 1
        v0, v1 = int(uniq[i]), int(uniq[j]) + 1
        chunk = store.read_rows(v0, v1)
        rows[i:j + 1] = chunk[uniq[i:j + 1] - v0]
        i = j + 1
    out[valid] = rows[inverse]
    return out
