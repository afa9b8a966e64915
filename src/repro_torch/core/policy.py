"""Hybrid format-selection policy (paper §V-D / future work §VI).

Figure 4 of the paper shows a crossover: when the storage-size difference
``compbin_size - webgraph_size`` is small (< ~50 GiB on the paper's
system), CompBin/binary CSR loads faster; when it approaches/exceeds
~100 GiB, WebGraph + PG-Fuse wins because the read becomes storage-
bandwidth limited.  The thresholds depend on storage bandwidth and
decompression throughput, so we model loading time explicitly and let the
constants be calibrated on the running system:

    t_compbin  = compbin_size / storage_bw + |E| / compbin_decode_rate
    t_webgraph = webgraph_size / storage_bw + |E| / webgraph_decode_rate

and choose the smaller.  ``calibrate()`` measures the two decode rates and
the storage bandwidth with short probes on generated data.
"""

from __future__ import annotations

import dataclasses
import io
import time
from typing import Optional

import numpy as np

from repro_torch.core import compbin, webgraph
from repro_torch.core.csr import CSR


@dataclasses.dataclass
class SystemModel:
    # cost-model constants kept from the JAX package, not GPU measurements
    storage_bw: float = 2e9            # bytes/s sequential read
    compbin_decode_rate: float = 2e8   # edges/s (shift+add, eq. 1)
    webgraph_decode_rate: float = 2e6  # edges/s (bit-level gamma/zeta)

    def load_time_compbin(self, n_vertices: int, n_edges: int) -> float:
        size = compbin.compbin_nbytes(n_vertices, n_edges)
        return size / self.storage_bw + n_edges / self.compbin_decode_rate

    def load_time_webgraph(self, webgraph_size: int, n_edges: int) -> float:
        return webgraph_size / self.storage_bw + n_edges / self.webgraph_decode_rate


def choose_format(n_vertices: int, n_edges: int, webgraph_size: int,
                  model: SystemModel | None = None) -> str:
    """Return 'compbin' or 'webgraph' — whichever the model predicts faster.

    ``webgraph_size`` must be the actual compressed size on storage (it is
    graph-dependent: web graphs compress far better than social/bio graphs).
    """
    model = model or SystemModel()
    t_cb = model.load_time_compbin(n_vertices, n_edges)
    t_wg = model.load_time_webgraph(webgraph_size, n_edges)
    return "compbin" if t_cb <= t_wg else "webgraph"


def crossover_size_difference(model: SystemModel, n_edges: int,
                              n_vertices: int) -> float:
    """Size difference (bytes) at which the two formats tie (paper Fig. 4).

    Setting t_cb == t_wg:  (cb_size - wg_size) / storage_bw ==
    |E|/wg_rate - |E|/cb_rate, i.e. the extra read time of the fat format
    must equal the extra decode time of the compressed one.
    """
    extra_decode = n_edges / model.webgraph_decode_rate - n_edges / model.compbin_decode_rate
    return extra_decode * model.storage_bw


@dataclasses.dataclass
class StreamDecodePlan:
    """Where the streaming loader (data/graph_stream.py) runs eq. (1)."""

    mode: str      # "device" (CUDA kernel) | "host" (numpy decode)
    reason: str

    @property
    def device(self) -> bool:
        return self.mode == "device"


def choose_stream_decode(format: str, b: int = 0,
                         model: SystemModel | None = None) -> StreamDecodePlan:
    """Per-graph decode placement for the streaming loader.

    Direct-addressing codecs (CompBin, LogCSR — both pack neighbors as
    eq. (1) byte streams) with b <= 4 ship the *packed* bytes and decode
    on device — the (4-b)/4 byte saving then applies to host->HBM
    traffic too, and the kernel's shift+ors are free next to the gather they
    feed.  b > 4 means |V| >= 2^32: IDs overflow the kernel's int32
    lanes, so the host decodes to int64.  WebGraph's gamma/zeta bit
    codes are inherently sequential (paper §II-A) and always decode on
    host; whether WebGraph is worth reading at all is
    :func:`choose_format`'s job, which trades its smaller storage
    footprint against its ~100x slower decode.
    """
    if format in ("compbin", "logcsr"):
        fmt = "CompBin" if format == "compbin" else "LogCSR"
        if 1 <= b <= 4:
            return StreamDecodePlan(
                "device", f"{fmt} b={b}: packed stream fits int32 lanes; "
                          f"H2D moves {b}/4 of the decoded bytes")
        return StreamDecodePlan(
            "host", f"{fmt} b={b}: IDs exceed int32; host decodes to int64")
    if format == "webgraph":
        return StreamDecodePlan(
            "host", "WebGraph gamma/zeta codes are bit-sequential; no device path")
    raise ValueError(f"unknown graph format {format!r}")


@dataclasses.dataclass
class AccessModePlan:
    """PG-Fuse configuration matched to an access pattern.

    Feed the fields into :func:`repro_torch.core.paragrapher.open_graph`
    (``pgfuse_readahead=plan.readahead, pgfuse_eviction=plan.eviction``)
    and, when ``churn_budget_fraction`` is set, cap the churning byte
    stream's file with ``fs.set_file_budget(path, int(frac * budget))``.
    """

    mode: str                 # "sequential" | "random"
    readahead: int            # PG-Fuse blocks prefetched per miss
    eviction: str             # pgfuse.EVICT_LRU | pgfuse.EVICT_CLOCK
    churn_budget_fraction: Optional[float]   # per-file cap for the bulk
                              # byte stream (None: no cap needed)
    reason: str

    @property
    def random(self) -> bool:
        return self.mode == "random"


def choose_access_mode(workload: str, *,
                       touch_fraction: Optional[float] = None
                       ) -> AccessModePlan:
    """Sequential-vs-random PG-Fuse policy from workload hints.

    The streaming loaders scan every byte once in order: always-on
    readahead turns ~every miss into one enlarged multi-block request,
    and exact LRU is the right replacement (a block is dead the moment
    the scan passes it).  Random adjacency queries (sampled minibatch
    training, online inference serving) invert both assumptions —
    "Making Caches Work for Graph Analytics" (arXiv:1608.01362) shows
    random graph access needs a policy that protects the re-referenced
    hot set rather than raw recency:

    * readahead OFF — the block after a queried adjacency list carries
      no locality, so prefetching it just churns the cache;
    * clock/second-chance eviction — hot blocks (offset array, hub
      vertices) are re-touched every batch and survive sweeps, while a
      strict recency order would evict them behind any large batch of
      cold packed-byte reads;
    * a per-file cap on the bulk/churning stream (packed neighbors rows
      vs. the offsets region's working set, feature store vs. topology)
      so churn reclaims from itself first.

    ``workload`` is "stream"/"scan" (sequential) or "sample"/"serve"
    (random).  ``touch_fraction`` (expected fraction of the file touched
    per epoch) overrides the keyword when given: a "sampler" that visits
    ~every vertex each epoch is effectively sequential.
    """
    sequential = {"stream", "scan", "sequential", "full"}
    random_ = {"sample", "serve", "query", "random"}
    if workload not in sequential | random_:
        raise ValueError(f"unknown workload {workload!r} "
                         f"(expected one of {sorted(sequential | random_)})")
    is_random = workload in random_
    if touch_fraction is not None:
        if not 0 <= touch_fraction <= 1:
            raise ValueError(f"touch_fraction must be in [0,1], "
                             f"got {touch_fraction}")
        # visiting most of the file per epoch amortizes like a scan even
        # if individual requests look random
        is_random = touch_fraction < 0.5
    if is_random:
        return AccessModePlan(
            mode="random", readahead=0, eviction="clock",
            churn_budget_fraction=0.5,
            reason=f"workload {workload!r}: no next-block locality; "
                   f"second-chance keeps the re-touched hot set; cap the "
                   f"packed/feature churn at half the budget")
    return AccessModePlan(
        mode="sequential", readahead=2, eviction="lru",
        churn_budget_fraction=None,
        reason=f"workload {workload!r}: one-pass scan wants enlarged "
               f"prefetch and exact recency eviction")


@dataclasses.dataclass
class QueryDecodePlan:
    """Where the query engine runs eq. (1) for ONE micro-batch."""

    mode: str      # "device" (one H2D + CUDA kernel) | "host" (numpy)
    reason: str

    @property
    def device(self) -> bool:
        return self.mode == "device"


#: below this many edges per micro-batch the device dispatch + transfer
#: overhead exceeds the host shift+adds it replaces (per-batch fixed cost
#: ~tens of microseconds vs ~5 ns/edge host decode — the cost model's
#: figures, kept from the JAX package; ``chip_smoke.py`` measures the real
#: crossover on the GPU and PERF.md records it)
QUERY_DEVICE_MIN_EDGES = 4096


def choose_query_decode(n_edges: int, b: int, *,
                        n_vertices: Optional[int] = None,
                        min_edges: int = QUERY_DEVICE_MIN_EDGES
                        ) -> QueryDecodePlan:
    """Per-micro-batch decode placement for the random-access query path.

    The serving engine knows each batch's exact edge mass AFTER the
    offsets gather and BEFORE any packed byte is decoded, so placement
    is a per-batch decision, not a per-engine one: large-fanout batches
    (hub-heavy frontiers, whole sampler layers) ship their merged packed
    runs to the device in one transfer and decode next to the gathers
    they feed — the H2D moves ``b/4`` of the decoded bytes, same as the
    streaming loader — while small batches stay on host, where eq. (1)
    costs less than a device dispatch.  Mirrors
    :func:`choose_stream_decode`'s lane constraint: IDs must fit int32
    lanes, so ``b > 4`` or ``|V| > 2^31`` always decodes on host.
    """
    if n_edges < 0:
        raise ValueError(f"n_edges must be >= 0, got {n_edges}")
    if not 1 <= b <= 8:
        raise ValueError(f"b must be in [1,8], got {b}")
    if b > 4:
        return QueryDecodePlan(
            "host", f"CompBin b={b}: IDs exceed int32 lanes; host decodes")
    if n_vertices is not None and n_vertices > (1 << 31):
        return QueryDecodePlan(
            "host", f"|V|={n_vertices} overflows int32 lanes; host decodes")
    if n_edges < min_edges:
        return QueryDecodePlan(
            "host", f"batch of {n_edges} edges < {min_edges}: device "
                    f"dispatch+transfer overhead exceeds the shift+adds")
    return QueryDecodePlan(
        "device", f"batch of {n_edges} edges: one H2D of {b}*{n_edges} "
                  f"packed bytes, GPU decode next to the gathers it feeds")


@dataclasses.dataclass
class AdmissionPlan:
    """Load-shedding gate sizing for the traversal/serving layer.

    The gate admits at most ``max_inflight`` requests (being served OR
    queued) and at most ``max_edges_inflight`` of summed per-request
    edge budgets at any instant; everything beyond is SHED immediately
    (fast-fail, so overload surfaces as an explicit signal the client
    can back off on, never as unbounded queueing delay).  ``servers``
    is the number of requests the service executes concurrently —
    the quantity the queue-depth arithmetic below divides by.
    """

    max_inflight: int         # admitted (served + queued) request cap
    max_edges_inflight: int   # summed admitted edge budgets cap
    servers: int              # concurrent executors behind the gate
    slo_s: float              # the latency objective the sizing protects
    reason: str


def choose_admission(slo_s: float, *, edge_budget: int,
                     service_edges_per_s: float, servers: int = 1,
                     overshoot_factor: float = 2.0) -> AdmissionPlan:
    """Size the admission gate so every ADMITTED request meets the SLO.

    Classic bounded-queue arithmetic: one request costs at most
    ``t_req = overshoot_factor * edge_budget / service_edges_per_s``
    (the traversal loop stops at the first frontier that crosses the
    edge budget, so a request can overshoot its budget by up to one
    frontier — ``overshoot_factor`` covers that).  A request admitted
    behind ``q`` others waits at most ``ceil(q / servers) * t_req``
    before its own ``t_req`` of service, so admitting at most

        max_inflight = floor(slo_s * servers / t_req)

    keeps worst-case admitted latency inside ``slo_s``.  Shedding is
    then the ONLY overload response: p99 of admitted requests is a
    sizing invariant, and the shed rate — not the tail — absorbs the
    excess (the deterministic load test pins exactly this).
    """
    if slo_s <= 0 or edge_budget < 1 or service_edges_per_s <= 0:
        raise ValueError("slo_s, edge_budget and service_edges_per_s must "
                         "be positive")
    if servers < 1 or overshoot_factor < 1:
        raise ValueError("servers must be >= 1 and overshoot_factor >= 1")
    t_req = overshoot_factor * edge_budget / service_edges_per_s
    max_inflight = max(1, int(slo_s * servers / t_req))
    return AdmissionPlan(
        max_inflight=max_inflight,
        max_edges_inflight=max_inflight * edge_budget,
        servers=servers, slo_s=slo_s,
        reason=f"worst-case request {t_req * 1e3:.2f} ms "
               f"({overshoot_factor}x overshoot on {edge_budget} edges); "
               f"{max_inflight} in flight across {servers} server(s) keeps "
               f"admitted latency <= {slo_s * 1e3:.1f} ms; excess sheds")


@dataclasses.dataclass
class ShardPlan:
    """Scale-out layout for the sharded serving path
    (:class:`repro_torch.query.sharded.ShardedQueryService`).

    ``n_shards`` contiguous vertex-range shards, each replicated
    ``replication`` times (every replica owns its own PG-Fuse mount and
    engine, simulated-process style).  ``routing`` is how a request's
    per-shard slice picks among that shard's replicas: ``"direct"``
    (single replica) or ``"rr"`` (deterministic round-robin — the
    load-balancing mode hub-heavy zipf traffic needs).
    """

    n_shards: int
    replication: int
    routing: str      # "direct" | "rr"
    reason: str


def choose_shard_plan(file_bytes: int, *, cache_budget_bytes: int,
                      hot_fraction: float = 0.0,
                      offered_edges_per_s: Optional[float] = None,
                      shard_edges_per_s: Optional[float] = None,
                      max_shards: int = 16) -> ShardPlan:
    """Shard count / replication / routing from cache budgets and trace
    skew.

    Two quantities size the shard count, and the larger wins:

    * **working set vs cache budget** — each shard serves one
      contiguous vertex range, so its PG-Fuse working set is roughly
      ``file_bytes / n_shards``; at least
      ``ceil(file_bytes / cache_budget_bytes)`` shards keep every
      shard's hot set resident in its own budget (the per-shard
      locality lever: smaller working set per worker, the same effect
      "Making Caches Work for Graph Analytics" gets from cache-
      segmented hot sets);
    * **offered load vs per-shard service rate** — when both are
      known, at least ``ceil(offered_edges_per_s / shard_edges_per_s)``
      shards carry the traffic.

    ``hot_fraction`` is the measured fraction of routed traffic landing
    on the HOTTEST shard's range (read it off a trace via the sharded
    service's router counters).  Range sharding cannot balance a trace
    whose hubs concentrate in one range: once one shard absorbs >= half
    the traffic, the plan replicates every shard 2x and routes
    round-robin so the hub shard's replicas split its load.
    """
    if file_bytes < 0:
        raise ValueError(f"file_bytes must be >= 0, got {file_bytes}")
    if cache_budget_bytes < 1:
        raise ValueError(f"cache_budget_bytes must be >= 1, "
                         f"got {cache_budget_bytes}")
    if not 0 <= hot_fraction <= 1:
        raise ValueError(f"hot_fraction must be in [0, 1], "
                         f"got {hot_fraction}")
    if max_shards < 1:
        raise ValueError(f"max_shards must be >= 1, got {max_shards}")
    if (offered_edges_per_s is None) != (shard_edges_per_s is None):
        raise ValueError("offered_edges_per_s and shard_edges_per_s "
                         "must be given together")
    n_cache = max(1, -(-file_bytes // cache_budget_bytes))
    n_load = 1
    if offered_edges_per_s is not None:
        if offered_edges_per_s < 0 or shard_edges_per_s <= 0:
            raise ValueError("offered_edges_per_s must be >= 0 and "
                             "shard_edges_per_s > 0")
        n_load = max(1, -(-int(offered_edges_per_s)
                          // max(1, int(shard_edges_per_s))))
    n_shards = min(max(n_cache, n_load), max_shards)
    replication = 2 if hot_fraction >= 0.5 else 1
    routing = "rr" if replication > 1 else "direct"
    return ShardPlan(
        n_shards=n_shards, replication=replication, routing=routing,
        reason=f"{n_cache} shard(s) fit {file_bytes} B working set into "
               f"{cache_budget_bytes} B/shard cache budgets, {n_load} "
               f"carry the offered load (capped at {max_shards}); "
               f"hottest range takes {hot_fraction:.0%} of traffic -> "
               f"{replication}x replicas, {routing} routing")


@dataclasses.dataclass
class HotSetPlan:
    """Admission/placement config for the HBM-resident hot-set tier
    (:class:`repro_torch.query.hotset.HotSetCache`) — cache tier 3, above
    PG-Fuse's host-RAM packed blocks.

    An entry costs ``8 * degree`` budget bytes (a decoded int64 run),
    so every threshold below is a *degree*: the tier exists for the
    hub vertices zipf traffic concentrates on, and the arithmetic keeps
    the cold tail out of their way.
    """

    budget_bytes: int      # resident cap, EngineShare-style byte budget
    min_degree: int        # below: BYPASS the tier (cold tail)
    pin_degree: int        # at/above: PIN (the clock sweep never takes it)
    pin_fraction: float    # budget fraction pinned entries may occupy
    place: str             # "device" (HBM int32 runs) | "host" (numpy)
    prefetch_min_hits: int  # trace hits before a vertex is predicted hot
    prefetch_batch: int    # predicted vertices fetched per request batch
    reason: str

    @property
    def device(self) -> bool:
        return self.place == "device"


def choose_hotset_admission(n_vertices: int, n_edges: int,
                            budget_bytes: int, *,
                            pin_fraction: float = 0.5,
                            prefetch_min_hits: int = 3,
                            prefetch_batch: int = 8) -> HotSetPlan:
    """Degree-aware admission for the device-resident hot-set tier.

    Power-law graphs put almost all query traffic on vertices whose
    degree is a large multiple of the mean ("Making Caches Work for
    Graph Analytics": frequency-clustered hot sets), while the tail —
    most vertices — is touched rarely and decodes cheaply anyway.  The
    thresholds follow directly:

    * ``min_degree = max(2, 2 * mean_degree)`` — an entry below twice
      the mean is tail, not hub: admitting it spends budget (and an
      eviction later) to save a decode that was already near-free, and
      Slim Graph's lossy-tier argument applies one tier down — let the
      tail fall through to PG-Fuse;
    * ``pin_degree = max(min_degree, 16 * mean_degree)`` — an order of
      magnitude above the mean the re-reference probability under zipf
      traffic is ~1 per batch, so second-chance bookkeeping is wasted
      motion: pin it (up to ``pin_fraction`` of the budget) and let the
      clock sweep manage only the warm middle;
    * ``place`` mirrors :func:`choose_query_decode`'s lane constraint:
      ids fit the device's int32 lanes only while ``|V| <= 2^31``, so
      larger graphs keep the tier host-resident (still skipping decode
      — just not the H2D).
    """
    if n_vertices < 0 or n_edges < 0:
        raise ValueError("n_vertices and n_edges must be >= 0")
    if budget_bytes < 1:
        raise ValueError(f"budget_bytes must be >= 1, got {budget_bytes}")
    if not 0.0 <= pin_fraction <= 1.0:
        raise ValueError(f"pin_fraction must be in [0, 1], "
                         f"got {pin_fraction}")
    mean = n_edges / n_vertices if n_vertices else 0.0
    min_degree = max(2, int(2 * mean))
    pin_degree = max(min_degree, int(16 * mean))
    place = "device" if n_vertices <= (1 << 31) else "host"
    return HotSetPlan(
        budget_bytes=int(budget_bytes),
        min_degree=min_degree, pin_degree=pin_degree,
        pin_fraction=float(pin_fraction), place=place,
        prefetch_min_hits=int(prefetch_min_hits),
        prefetch_batch=int(prefetch_batch),
        reason=f"mean degree {mean:.1f}: bypass < {min_degree}, pin >= "
               f"{pin_degree} (<= {pin_fraction:.0%} of {budget_bytes} B); "
               f"{place}-resident runs "
               f"({'ids fit int32 lanes' if place == 'device' else 'ids overflow int32 lanes'})")


@dataclasses.dataclass
class ReorderPlan:
    """Vertex-ordering strategy for the offline graph compiler
    (:func:`repro_torch.graph.reorder.compile_graph`).

    ``strategy`` is one of ``"bfs"`` (level order from a max-degree
    root — the locality permutation that clusters each neighborhood's
    ids), ``"degree"`` (hubs first — the cheap frequency clustering),
    or ``"identity"`` (keep the input order).
    """

    strategy: str   # "bfs" | "degree" | "identity"
    reason: str


REORDER_STRATEGIES = ("bfs", "degree", "identity")


def choose_reorder(n_vertices: int, n_edges: int, *,
                   strategy: Optional[str] = None) -> ReorderPlan:
    """Pick the locality permutation the graph compiler applies.

    BFS order from a max-degree root is the default: it places each
    neighborhood's vertices near each other, so a query's packed-byte
    reads land in fewer PG-Fuse blocks and the ids inside a row become
    numerically close (the property Log(Graph)/Zuckerli-style encodings
    exploit; see PAPERS.md).  Degree order is the fallback when the
    graph is too sparse for BFS levels to mean anything — with mean
    degree < 1 most components are singletons and BFS degenerates to
    the component scan, so the cheap hubs-first sort (frequency
    clustering: the hot set lands in the first blocks) wins on compile
    time.  Edgeless graphs keep their order — any permutation is noise.
    An explicit ``strategy`` overrides the heuristic (the CLI flag).
    """
    if n_vertices < 0 or n_edges < 0:
        raise ValueError("n_vertices and n_edges must be >= 0")
    if strategy is not None:
        if strategy not in REORDER_STRATEGIES:
            raise ValueError(f"unknown reorder strategy {strategy!r} "
                             f"(expected one of {REORDER_STRATEGIES})")
        return ReorderPlan(strategy=strategy,
                           reason=f"explicit strategy {strategy!r}")
    if n_edges == 0:
        return ReorderPlan(
            strategy="identity",
            reason="edgeless graph: no locality to recover")
    mean = n_edges / max(1, n_vertices)
    if mean < 1.0:
        return ReorderPlan(
            strategy="degree",
            reason=f"mean degree {mean:.2f} < 1: BFS levels degenerate; "
                   f"hubs-first sort clusters the hot set cheaply")
    return ReorderPlan(
        strategy="bfs",
        reason=f"mean degree {mean:.2f}: level order from a max-degree "
               f"root clusters neighborhoods into few blocks")


def choose_stream_parts(n_devices_total: int = 1, process_count: int = 1,
                        min_parts_per_process: int = 8) -> int:
    """Global partition count for a (possibly multi-host) streamed load.

    Each process should see enough partitions to keep its pipeline's
    double-buffering busy (at least ``min_parts_per_process``) and enough
    to cover its devices 4x over (so the edge-balanced
    plan can absorb skew).  The returned count is the GLOBAL plan size:
    every process computes the same plan from the same file and takes its
    ``split_plan`` slice, so the cut points agree without communication.
    """
    if process_count < 1:
        raise ValueError(f"process_count must be >= 1, got {process_count}")
    devices_per_process = max(1, n_devices_total // process_count)
    per = max(min_parts_per_process, 4 * devices_per_process)
    return per * process_count


def choose_feature_align(block_size: int, row_bytes: int,
                         n_vertices: Optional[int] = None,
                         process_count: int = 1,
                         min_cuts_per_host: int = 2) -> int:
    """Vertex alignment for block-disjoint per-host feature reads.

    Cut vertices that are multiples of ``block_size // row_bytes`` land
    on feature-store block boundaries (given a block-aligned data
    section), so neighboring hosts never double-fetch a boundary block.
    But alignment is an *optimization*: when the grid is coarser than
    ``min_cuts_per_host`` grid points per host, snapping would starve
    whole hosts (a 1024-vertex graph with 1024-vertex blocks has exactly
    one interior grid point), so the policy degrades to 1 — unaligned
    cuts and one shared boundary block per host pair, the pre-alignment
    behavior.
    """
    if block_size < 1 or process_count < 1:
        raise ValueError("block_size and process_count must be >= 1")
    if row_bytes <= 0:
        return 1
    align = max(1, block_size // row_bytes)
    if (n_vertices is not None
            and align * process_count * min_cuts_per_host > n_vertices):
        return 1
    return align


def calibrate(n_vertices: int = 1 << 16, n_edges: int = 1 << 18,
              seed: int = 0) -> SystemModel:
    """Measure decode rates (and a proxy storage bandwidth) on this host."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges)
    dst = rng.integers(0, n_vertices, n_edges)
    from repro_torch.core.csr import csr_from_edges
    csr = csr_from_edges(src, dst, n_vertices, dedupe=True)
    n_edges = csr.n_edges

    cb_blob = io.BytesIO()
    compbin.write_compbin(cb_blob, csr)
    t0 = time.perf_counter()
    compbin.read_compbin(io.BytesIO(cb_blob.getvalue()))
    cb_rate = n_edges / max(1e-9, time.perf_counter() - t0)

    wg_blob = io.BytesIO()
    webgraph.write_webgraph(wg_blob, csr)
    t0 = time.perf_counter()
    webgraph.read_webgraph(io.BytesIO(wg_blob.getvalue()))
    wg_rate = n_edges / max(1e-9, time.perf_counter() - t0)

    # memory-to-memory copy as an upper-bound "storage" bandwidth proxy on
    # this container; real deployments should pass a measured device figure.
    blob = cb_blob.getvalue()
    t0 = time.perf_counter()
    _ = bytes(blob)
    bw = len(blob) / max(1e-9, time.perf_counter() - t0)

    return SystemModel(storage_bw=bw, compbin_decode_rate=cb_rate,
                       webgraph_decode_rate=wg_rate)
