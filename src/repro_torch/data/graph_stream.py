"""Streaming partition->device graph loader (the paper's loading path,
carried all the way to the accelerator).

The paper accelerates storage->host loading (PG-Fuse enlarges+caches
reads, CompBin keeps decode a few shifts-and-adds); this module connects
that work to the GPU so the *consumer* of the bandwidth is the device,
not host RAM:

    GraphHandle.partition_plan          edge-balanced vertex ranges
      -> read_async over PG-Fuse        producer pool, bounded buffers,
                                        sequential block readahead
      -> raw packed neighbor bytes      CompBin: NO host decode
      -> feature rows (stream_features) core.featstore through the SAME
                                        PG-Fuse mount, per vertex range
      -> double-buffered H2D transfer   PrefetchIterator staging thread
      -> on-device CUDA decode          kernels/compbin_decode, eq. (1)
      -> per-partition CSR shards (+x)  resident in HBM on ``device``

For CompBin with b <= 4 the packed stream crosses the host->device link
undecoded, so the (4-b)/4 byte saving the paper claims for storage also
applies to H2D traffic — the same argument Log(Graph)/Zuckerli make for
compact representations: judge them by the bandwidth of the consumer
path.  WebGraph inputs (and CompBin with b > 4, whose IDs overflow int32
lanes) fall back to host decode; core/policy.py::choose_stream_decode is
the policy hook that picks the placement per graph.

Entry point::

    stream = stream_partitions(graph, device, n_buffers=2, readahead=2)
    for shard in stream:          # StreamedShard, device-resident
        ...
    print(stream.stats)           # per-stage: storage, H2D, decode

The iterator is bounded and backpressured end to end: at most
``readahead`` partitions sit decoded-or-packed on the host and at most
``n_buffers`` shards sit staged on device ahead of the consumer; a slow
consumer stalls the producers through the read_async buffer pool.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import pgfuse, policy
from repro_torch.core.csr import CSR
from repro_torch.core.featstore import rows_to_tensor
from repro_torch.core.paragrapher import GraphHandle, PartitionBuffer


@dataclasses.dataclass
class StreamedShard:
    """One device-resident CSR partition (vertices [v0, v1))."""

    v0: int
    v1: int
    offsets: torch.Tensor     # int64[v1-v0+1], rebased to 0, on the device
    neighbors: torch.Tensor   # int32[n_edges] on the device
    n_edges: int
    x: Optional[torch.Tensor] = None  # float[v1-v0, d] feature rows, when
                                      # a feature store is streamed alongside
    y: Optional[torch.Tensor] = None  # u8[v1-v0, 2] label family rows
                                      # ([class id, train-mask flag]), when a
                                      # label store is streamed alongside

    @property
    def n_vertices(self) -> int:
        return self.v1 - self.v0


#: StreamStats fields with dedicated merge rules (durations sum/max,
#: mode/reason strings tie-break); every OTHER field is a counter and
#: sums — derived from the dataclass so new counters merge automatically.
_MERGE_SPECIAL_FIELDS = ("decode_mode", "decode_reason", "decode_s", "wall_s")


@dataclasses.dataclass
class StreamStats:
    """Per-stage accounting for one stream (printed by benchmarks).

    In a multi-host load each process carries its own instance; per-host
    stats combine with :meth:`merge` (associative, so any reduction tree
    over the hosts yields the same totals).
    """

    partitions: int = 0
    vertices: int = 0
    edges: int = 0
    decode_mode: str = ""          # "device" | "host" ("mixed" after merge)
    decode_reason: str = ""
    # storage stage (PG-Fuse deltas; zero when the graph is not mounted)
    underlying_reads: int = 0
    underlying_bytes: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    readahead_blocks: int = 0
    # transfer stage
    bytes_h2d: int = 0             # topology bytes host->device (packed!)
    # decode stage
    host_decode_bytes: int = 0     # packed bytes decoded on host (0 = all
    decode_s: float = 0.0          # on-device, the CompBin fast path)
    # feature stage (stream_features; zero when no store is attached)
    feature_rows: int = 0          # feature rows streamed
    feature_bytes: int = 0         # bytes read from the feature store
    feature_bytes_h2d: int = 0     # feature bytes shipped host->device
    feature_read_s: float = 0.0    # time in feature-store reads
    feature_cache_hits: int = 0    # the store's own PG-Fuse block cache
    feature_cache_misses: int = 0
    # label stage (second column family; zero when no label store)
    label_rows: int = 0            # label/mask rows streamed
    label_bytes: int = 0           # bytes read from the label store
    wall_s: float = 0.0

    # Every derived rate guards against zero/negative durations: a stage
    # that never ran (empty plan slice on a host, sub-timer-resolution
    # decode) reports 0.0 instead of dividing by zero.
    @property
    def decode_edges_per_s(self) -> float:
        return self.edges / self.decode_s if self.decode_s > 0 else 0.0

    @property
    def h2d_bytes_per_s(self) -> float:
        return self.bytes_h2d / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def edges_per_s(self) -> float:
        return self.edges / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def feature_bytes_per_s(self) -> float:
        return self.feature_bytes / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def feature_hit_rate(self) -> float:
        n = self.feature_cache_hits + self.feature_cache_misses
        return self.feature_cache_hits / n if n else 0.0

    def merge(self, other: "StreamStats") -> "StreamStats":
        """Combine two hosts' stats into the aggregate (returns a new
        instance).  Counters sum; decode seconds sum (total decode work);
        wall seconds take the max (hosts stream concurrently); mode/reason
        collapse to "mixed"/"" when the hosts disagree.
        """
        merged = {f.name: getattr(self, f.name) + getattr(other, f.name)
                  for f in dataclasses.fields(self)
                  if f.name not in _MERGE_SPECIAL_FIELDS}
        mode = (self.decode_mode if self.decode_mode == other.decode_mode
                else "mixed")
        reason = (self.decode_reason
                  if self.decode_reason == other.decode_reason else "")
        return StreamStats(decode_mode=mode, decode_reason=reason,
                           decode_s=self.decode_s + other.decode_s,
                           wall_s=max(self.wall_s, other.wall_s), **merged)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["decode_edges_per_s"] = self.decode_edges_per_s
        d["h2d_bytes_per_s"] = self.h2d_bytes_per_s
        d["edges_per_s"] = self.edges_per_s
        d["feature_bytes_per_s"] = self.feature_bytes_per_s
        d["feature_hit_rate"] = self.feature_hit_rate
        return d


def merge_stats(stats: Iterable[StreamStats]) -> StreamStats:
    """Fold any number of per-host stats into one aggregate."""
    out = StreamStats()
    first = True
    for s in stats:
        out = dataclasses.replace(s) if first else out.merge(s)
        first = False
    return out


class GraphStream:
    """Bounded, backpressured iterator of device-resident CSR shards.

    Use :func:`stream_partitions` to construct.  Safe to abandon early:
    ``close()`` (also called by ``__exit__`` and on exhaustion) drops the
    in-flight partitions and unblocks the producer pool.
    """

    def __init__(self, graph: GraphHandle,
                 device: "torch.device | str | None" = None, *,
                 n_buffers: int = 2, readahead: int = 2,
                 n_parts: Optional[int] = None, n_workers: int = 2,
                 granule: Optional[int] = None,
                 decode_plan: Optional[policy.StreamDecodePlan] = None,
                 process_index: int = 0, process_count: int = 1,
                 feature_path=None, label_path=None, shares=None,
                 align: int = 1):
        from repro_torch.distributed.sharding import stream_shard_placement
        from repro_torch.kernels.compbin_decode import STREAM_GRANULE_IDS
        from repro_torch.graph.partition import host_vertex_range, split_plan

        if not 0 <= process_index < process_count:
            raise ValueError(
                f"process_index {process_index} not in [0, {process_count})")
        self._graph = graph
        # where shards live: None = the GPU; raises here, before any
        # thread starts, when there is none
        self._nbr_device, self._off_device = stream_shard_placement(
            device, 0, process_index=process_index,
            process_count=process_count)
        self._granule = granule or STREAM_GRANULE_IDS
        self.process_index = process_index
        self.process_count = process_count
        # Every process derives the SAME global plan from the same file,
        # then streams only its split_plan slice — the cut points agree
        # across hosts with no communication (the plan, the capacity
        # ``shares``, and the block grid ``align`` are the same inputs on
        # every host; shares come from allgathered last-epoch stats, see
        # graph.partition.resplit_from_stats).
        self.global_plan = graph.partition_plan(
            self._default_parts(n_parts, process_count))
        self.plan = split_plan(self.global_plan, process_count,
                               shares=shares, align=align)[process_index]
        self.host_range = host_vertex_range(self.plan)
        self.decode_plan = decode_plan or policy.choose_stream_decode(
            graph.format, graph.bytes_per_id)
        self.stats = StreamStats(decode_mode=self.decode_plan.mode,
                                 decode_reason=self.decode_plan.reason)
        # stream_features stage: the node-feature store rides the same
        # PG-Fuse mount as the topology (shared memory budget + readahead
        # policy, its own per-file block cache and stats)
        self._features = None
        self._feat0 = pgfuse.PGFuseStats()
        if feature_path is not None:
            from repro_torch.core import featstore
            self._features = featstore.open_featstore(feature_path,
                                                      fs=graph.fs)
            if self._features.n_rows != graph.n_vertices:
                self._features.close()
                raise ValueError(
                    f"feature store {feature_path} has "
                    f"{self._features.n_rows} rows for a graph of "
                    f"{graph.n_vertices} vertices")
            self._feat0 = self._features.pgfuse_stats() or pgfuse.PGFuseStats()
        # the label/mask column family rides the same mount the same way
        self._labels = None
        if label_path is not None:
            from repro_torch.core import featstore
            try:
                self._labels = featstore.open_featstore(label_path,
                                                        fs=graph.fs)
            except BaseException:
                if self._features is not None:
                    self._features.close()
                raise
            if self._labels.n_rows != graph.n_vertices:
                self._labels.close()
                if self._features is not None:
                    self._features.close()
                raise ValueError(
                    f"label store {label_path} has {self._labels.n_rows} "
                    f"rows for a graph of {graph.n_vertices} vertices")
        self._n_expected = len(self.plan)
        self._closed = False
        self._drop = threading.Event()   # tells the callback to discard
        self._t0 = time.perf_counter()
        # topology storage deltas come from the graph FILE's cache, not
        # the mount aggregate — a feature store on the same mount must
        # not leak its traffic into the topology counters
        self._pg0 = graph.pgfuse_file_stats() or pgfuse.PGFuseStats()

        # stage 1: storage + (for "host" mode) decode, on the producer pool
        self._rawq: "queue.Queue" = queue.Queue(maxsize=max(1, readahead))
        self._async = graph.read_async(
            self.plan, self._on_partition, n_buffers=max(2, n_buffers),
            n_workers=max(1, n_workers), raw=self.decode_plan.device)

        # stage 2: H2D staging + device decode, on a prefetch thread
        from repro_torch.data.prefetch import PrefetchIterator
        self._prefetch: PrefetchIterator = PrefetchIterator(
            self._raw_iter(), depth=max(1, n_buffers), transform=self._stage)

    @staticmethod
    def _default_parts(n_parts: Optional[int],
                       process_count: int = 1) -> int:
        """GLOBAL partition count (an explicit ``n_parts`` is also global:
        it is the size of the shared plan the processes split).  Each
        process drives one device."""
        if n_parts is not None:
            return max(1, n_parts)
        return policy.choose_stream_parts(process_count, process_count)

    # -- stage 1: the read_async consumer callback -------------------------
    def _on_partition(self, buf: PartitionBuffer) -> None:
        if self._drop.is_set():
            return
        if buf.error is not None:
            item = ("err", buf.error)
        elif buf.packed is not None:
            item = ("raw", (buf.v0, buf.v1, buf.offsets, buf.packed, buf.b))
        else:
            item = ("host", (buf.v0, buf.v1, buf.offsets, buf.neighbors))
        while not self._drop.is_set():
            try:
                self._rawq.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def _raw_iter(self) -> Iterator:
        received = 0
        while received < self._n_expected:
            try:
                kind, payload = self._rawq.get(timeout=0.05)
            except queue.Empty:
                if self._drop.is_set():
                    return
                continue
            received += 1
            if kind == "err":
                raise payload
            yield (kind, payload)

    # -- stage 2: staging + decode ----------------------------------------
    def _stage(self, item) -> StreamedShard:
        from repro_torch.kernels.compbin_decode import (compbin_decode,
                                                        pad_packed_for_stream)

        kind, payload = item
        t0 = time.perf_counter()
        dev = self._nbr_device
        if kind == "raw":
            v0, v1, offs, packed, b = payload
            padded, n = pad_packed_for_stream(packed, b, granule=self._granule)
            dev_packed = torch.from_numpy(padded).to(dev)  # H2D: packed bytes
            decoded = compbin_decode(dev_packed, b)   # eq. (1) on device
            neighbors = decoded[:n]
            h2d = padded.nbytes
        else:  # host-decoded partition (WebGraph, or CompBin with b > 4)
            v0, v1, offs, nbrs = payload
            n = len(nbrs)
            dtype = np.int32 if self._graph.n_vertices <= np.iinfo(np.int32).max \
                else np.int64
            host_nbrs = np.ascontiguousarray(nbrs, dtype=dtype)
            neighbors = torch.from_numpy(host_nbrs).to(dev)
            h2d = host_nbrs.nbytes
            if self._graph.bytes_per_id > 0:
                # fixed-width packed bytes this partition decoded on the
                # host (any direct codec) — tallied per stream, NOT via
                # compbin's process-global counter, which concurrent
                # streams share
                self.stats.host_decode_bytes += n * self._graph.bytes_per_id
            else:
                self.stats.host_decode_bytes += host_nbrs.nbytes
        offsets = torch.from_numpy(
            np.ascontiguousarray(offs, dtype=np.int64)).to(self._off_device)
        if dev.type == "cuda":
            # charge copy + decode to this stage, not to the consumer's
            # first use: wait for THIS thread's stream (the copies and the
            # kernel were enqueued on it), not for the whole device
            torch.cuda.current_stream(dev).synchronize()
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.bytes_h2d += h2d + offs.nbytes
        # the feature stage runs OUTSIDE the decode timer: its cost is
        # feature_read_s, not decode_s
        x = self._stream_features(v0, v1)
        y = self._stream_labels(v0, v1)
        return StreamedShard(v0=v0, v1=v1, offsets=offsets,
                             neighbors=neighbors, n_edges=n, x=x, y=y)

    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        """Per-vertex rows (like offsets) to the shard's device, the copy
        finished before the shard is handed on."""
        out = rows_to_tensor(rows).to(self._off_device)
        if self._off_device.type == "cuda":
            torch.cuda.current_stream(self._off_device).synchronize()
        return out

    def _stream_features(self, v0: int, v1: int):
        """The stream_features stage: feature rows [v0, v1) from the
        attached store — PG-Fuse enlarged/cached reads, same staging
        thread as topology H2D, so feature transfer double-buffers ahead
        of the consumer exactly like the packed neighbor bytes do."""
        if self._features is None:
            return None
        t0 = time.perf_counter()
        rows = self._features.read_rows(v0, v1)
        self.stats.feature_read_s += time.perf_counter() - t0
        self.stats.feature_rows += rows.shape[0]
        self.stats.feature_bytes += rows.nbytes
        x = self._to_device(rows)
        self.stats.feature_bytes_h2d += rows.nbytes
        return x

    def _stream_labels(self, v0: int, v1: int):
        """The second column family: label/mask rows [v0, v1) from the
        attached store — tiny next to features, but streaming them means
        full-graph batches carry ZERO synthetic tensors."""
        if self._labels is None:
            return None
        rows = self._labels.read_rows(v0, v1)
        self.stats.label_rows += rows.shape[0]
        self.stats.label_bytes += rows.nbytes
        return self._to_device(rows)

    # -- the consumer-facing iterator --------------------------------------
    def __iter__(self) -> "GraphStream":
        return self

    def __next__(self) -> StreamedShard:
        try:
            shard = next(self._prefetch)
        except StopIteration:
            self._finalize()
            raise
        self.stats.partitions += 1
        self.stats.vertices += shard.n_vertices
        self.stats.edges += shard.n_edges
        return shard

    def _finalize(self) -> None:
        if self.stats.wall_s == 0.0:
            self.stats.wall_s = time.perf_counter() - self._t0
        pg = self._graph.pgfuse_file_stats()
        if pg is not None:
            self.stats.underlying_reads = pg.underlying_reads - self._pg0.underlying_reads
            self.stats.underlying_bytes = pg.underlying_bytes - self._pg0.underlying_bytes
            self.stats.cache_hits = pg.cache_hits - self._pg0.cache_hits
            self.stats.cache_misses = pg.cache_misses - self._pg0.cache_misses
            self.stats.readahead_blocks = pg.readahead_blocks - self._pg0.readahead_blocks
        if self._features is not None:
            fst = self._features.pgfuse_stats()
            if fst is not None:
                self.stats.feature_cache_hits = \
                    fst.cache_hits - self._feat0.cache_hits
                self.stats.feature_cache_misses = \
                    fst.cache_misses - self._feat0.cache_misses

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._drop.set()
        self._prefetch.close()
        while True:  # unblock any producer stuck on a full raw queue
            try:
                self._rawq.get_nowait()
            except queue.Empty:
                break
        self._finalize()
        if self._features is not None:
            self._features.close()
        if self._labels is not None:
            self._labels.close()

    def __enter__(self) -> "GraphStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def stream_partitions(graph: GraphHandle,
                      device: "torch.device | str | None" = None, *,
                      n_buffers: int = 2, readahead: int = 2,
                      n_parts: Optional[int] = None, n_workers: int = 2,
                      granule: Optional[int] = None,
                      decode_plan: Optional[policy.StreamDecodePlan] = None,
                      process_index: int = 0, process_count: int = 1,
                      feature_path=None, label_path=None, shares=None,
                      align: int = 1) -> GraphStream:
    """Stream an open graph to the device partition by partition.

    ``device=None`` means the GPU (raises when there is none); pass
    ``device="cpu"`` to keep the shards in host memory, where the decode
    takes the kernel's plain version.

    Parameters mirror the pipeline's three bounds: ``readahead`` partitions
    may wait decoded/packed on the host, ``n_buffers`` shards may sit on
    device ahead of the consumer, and the PG-Fuse *block* readahead is set
    when the graph is opened (``open_graph(pgfuse_readahead=...)``).
    ``decode_plan`` overrides core.policy's CompBin-vs-WebGraph placement.

    ``feature_path`` attaches a :mod:`repro_torch.core.featstore`
    node-feature store: each shard then carries its vertices' feature rows
    (``x``), read through the graph's PG-Fuse mount and copied to the
    shard's device alongside the topology (the ``stream_features`` stage;
    per-stage bytes and cache hit rates land in :class:`StreamStats`).
    ``label_path`` attaches the label/mask column family the same way
    (``graph.features.labelstore_for_graph``): shards then carry ``y``
    ([class id, train-mask] u8 rows).

    Multi-host: every process opens the graph itself (its own PG-Fuse
    cache) and passes its ``process_index`` out of ``process_count`` and
    its own ``device``.  All processes compute the same global plan; each
    streams only its contiguous
    :func:`repro_torch.graph.partition.split_plan` slice.  ``shares`` sizes
    the slices by measured host capacity
    (:func:`repro_torch.graph.partition.resplit_from_stats`) and ``align``
    snaps the inter-host cuts to a block grid.
    """
    return GraphStream(graph, device, n_buffers=n_buffers, readahead=readahead,
                       n_parts=n_parts, n_workers=n_workers, granule=granule,
                       decode_plan=decode_plan, process_index=process_index,
                       process_count=process_count, feature_path=feature_path,
                       label_path=label_path, shares=shares, align=align)


def assemble_csr(shards: list[StreamedShard]) -> CSR:
    """Reassemble streamed shards into one host CSR (tests/verification).

    Shards may arrive out of order (read_async completes as storage does);
    they are keyed by their vertex range.
    """
    shards = sorted(shards, key=lambda s: s.v0)
    offsets = [np.zeros(1, dtype=np.int64)]
    neighbors = []
    base = 0
    for s in shards:
        offs = s.offsets.cpu().numpy().astype(np.int64, copy=False)
        offsets.append(offs[1:] + base)
        base += int(offs[-1])
        neighbors.append(s.neighbors.cpu().numpy())
    nbrs = (np.concatenate(neighbors) if neighbors
            else np.zeros(0, dtype=np.int32))
    return CSR(offsets=np.concatenate(offsets), neighbors=nbrs)
