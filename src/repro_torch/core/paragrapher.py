"""ParaGrapher — the graph-loading API (paper §II-A).

ParaGrapher lets graph frameworks load large compressed graphs with minimal
overhead, offering

  * **full** or **partition** loads,
  * **synchronous** (blocking) or **asynchronous** (non-blocking, callback)
    reads, and
  * a **producer/consumer** architecture with reusable bounded buffers: the
    producers decode partitions into a fixed pool of buffers; the consumer's
    callback hands each buffer to the user, who copies into the framework's
    preferred memory, after which the buffer returns to the pool.

In the original system the consumer side is C and the producer side is the
Java WebGraph process communicating over shared memory; here both sides are
Python threads sharing numpy buffers, which preserves the architecture
(bounded reusable buffers, backpressure when the consumer is slow) without
the JVM.  Formats: CompBin (paper §IV) and the WebGraph-style codec
(paper §II-A); PG-Fuse (paper §III) is interposed when requested.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Callable, Iterable, Optional, Sequence, Union

import numpy as np

from repro_torch.core import codec, pgfuse, webgraph
from repro_torch.core.csr import CSR

FORMAT_COMPBIN = "compbin"
FORMAT_WEBGRAPH = "webgraph"
FORMAT_LOGCSR = "logcsr"


def detect_format(path: Union[str, os.PathLike]) -> str:
    """Codec name for ``path``, dispatched on the 4-byte magic through
    the :mod:`repro_torch.core.codec` registry."""
    with open(path, "rb") as f:
        magic = f.read(4)
    spec = codec.codec_for_magic(magic)
    if spec is None:
        raise ValueError(f"{path}: unknown graph format (magic {magic!r})")
    return spec.name


@dataclasses.dataclass
class PartitionBuffer:
    """One reusable producer->consumer buffer (paper's shared buffers)."""

    v0: int = 0
    v1: int = 0
    offsets: Optional[np.ndarray] = None    # local, rebased to 0
    neighbors: Optional[np.ndarray] = None  # decoded IDs (raw=False)
    packed: Optional[np.ndarray] = None     # undecoded CompBin bytes (raw=True)
    b: int = 0                              # bytes/ID of ``packed``
    error: Optional[BaseException] = None


class GraphHandle:
    """An open graph. Thread-safe: each reader op opens its own file handle."""

    def __init__(self, path: Union[str, os.PathLike], *,
                 format: str = "auto",
                 use_pgfuse: bool = False,
                 pgfuse_block_size: int = pgfuse.DEFAULT_BLOCK_SIZE,
                 pgfuse_max_resident_bytes: Optional[int] = None,
                 pgfuse_readahead: Optional[int] = None,
                 pgfuse_pread_fn=None,
                 pgfuse_eviction: str = pgfuse.EVICT_LRU,
                 pgfuse_retries: int = 0,
                 pgfuse_retry_backoff_s: float = 0.005,
                 pgfuse_fs: Optional[pgfuse.PGFuseFS] = None,
                 pgfuse_engine=None):
        self.path = os.fspath(path)
        self.format = detect_format(path) if format == "auto" else format
        self._fs: Optional[pgfuse.PGFuseFS] = None
        self._owns_fs = False
        if pgfuse_fs is not None:
            # multi-tenant: join an existing mount (several serving
            # models under one budget); this graph's file takes the
            # caller's readahead ONLY when explicitly given (None
            # inherits the mount default and never clobbers a live
            # file's setting), and closing the handle unmounts only
            # this file, never the other tenants'
            self._fs = pgfuse_fs
            self._fs.mount(self.path, readahead=pgfuse_readahead,
                           engine=pgfuse_engine)
            # refcounted: another handle over the SAME file (two tenants,
            # one topology) keeps the cache warm past our close()
            self._fs.retain(self.path)
        elif use_pgfuse:
            self._fs = pgfuse.PGFuseFS(
                block_size=pgfuse_block_size,
                max_resident_bytes=pgfuse_max_resident_bytes,
                readahead=pgfuse_readahead or 0,
                pread_fn=pgfuse_pread_fn,
                eviction=pgfuse_eviction,
                retries=pgfuse_retries,
                retry_backoff_s=pgfuse_retry_backoff_s,
            )
            self._owns_fs = True
            self._fs.mount(self.path, engine=pgfuse_engine)
        self._closed = False
        try:
            rdr = self._reader()  # validates header eagerly
            self.n_vertices = rdr.n_vertices
            self.n_edges = rdr.n_edges
            # fixed bytes/ID of direct codecs (§IV packing); 0 for
            # formats without fixed-width IDs (bit-coded WebGraph)
            self.bytes_per_id = getattr(rdr, "b", 0)
            rdr.close()
        except BaseException:
            # a failed open must not strand the mount: unwind the retain
            # (shared fs) / the whole private fs, or the refcount and any
            # share membership leak with no handle left to release them
            if self._fs is not None:
                if self._owns_fs:
                    self._fs.unmount()
                else:
                    self._fs.unmount(self.path)
            raise

    # -- internals ----------------------------------------------------------
    def _open_file(self):
        if self._fs is not None:
            return self._fs.open(self.path)
        return open(self.path, "rb")

    def _reader(self):
        f = self._open_file()
        try:
            return codec.get_codec(self.format).open(f)
        except BaseException:
            f.close()
            raise

    # -- synchronous (blocking) API ------------------------------------------
    def read_full(self) -> CSR:
        if self._closed:
            raise ValueError("read on closed graph")
        rdr = self._reader()
        try:
            return rdr.read_full()
        finally:
            rdr.close()

    def read_partition(self, v0: int, v1: int) -> tuple[np.ndarray, np.ndarray]:
        """Load vertices [v0, v1): (rebased offsets[v1-v0+1], neighbors)."""
        if not 0 <= v0 <= v1 <= self.n_vertices:
            raise ValueError(f"bad partition [{v0},{v1}) for |V|={self.n_vertices}")
        rdr = self._reader()
        try:
            return rdr.read_partition(v0, v1)
        finally:
            rdr.close()

    def read_partition_raw(self, v0: int, v1: int
                           ) -> tuple[np.ndarray, np.ndarray, int]:
        """Like :meth:`read_partition` but WITHOUT host decode: returns
        (rebased offsets, packed neighbor bytes, bytes-per-ID).

        Only direct-addressing codecs (CompBin, LogCSR) support this —
        their packed streams are decodable on device
        (kernels/compbin_decode), so the (4-b)/4 byte saving extends to
        the host->device transfer.  WebGraph's bit-level codes need the
        sequential host decoder; callers should route through
        :func:`repro_torch.core.policy.choose_stream_decode`.
        """
        if not 0 <= v0 <= v1 <= self.n_vertices:
            raise ValueError(f"bad partition [{v0},{v1}) for |V|={self.n_vertices}")
        rdr = self._reader()
        try:
            if not hasattr(rdr, "raw_neighbor_bytes"):
                raise ValueError(f"raw partition reads require a "
                                 f"direct-addressing codec, "
                                 f"not {self.format!r}")
            offs = rdr.offsets(v0, v1)
            raw = rdr.raw_neighbor_bytes(int(offs[0]), int(offs[-1]))
            return (offs - offs[0]).astype(np.int64), raw, rdr.b
        finally:
            rdr.close()

    def neighbors_of(self, v: int) -> np.ndarray:
        rdr = self._reader()
        try:
            return np.asarray(rdr.neighbors_of(v))
        finally:
            rdr.close()

    # -- asynchronous (non-blocking) API --------------------------------------
    def read_async(
        self,
        partitions: Sequence[tuple[int, int]],
        callback: Callable[[PartitionBuffer], None],
        *,
        n_buffers: int = 4,
        n_workers: int = 4,
        raw: bool = False,
    ) -> "AsyncRead":
        """Decode ``partitions`` concurrently; invoke ``callback(buffer)`` for
        each as it completes (possibly out of order).  The pool of
        ``n_buffers`` bounds memory and applies backpressure: producers block
        until the consumer returns a buffer (i.e. the callback finishes).

        ``raw=True`` (CompBin only) skips host decode: each buffer carries
        ``packed``/``b`` instead of ``neighbors`` — the streaming loader's
        storage stage (data/graph_stream.py)."""
        return AsyncRead(self, list(partitions), callback,
                         n_buffers=n_buffers, n_workers=n_workers, raw=raw)

    def partition_plan(self, n_parts: int) -> list[tuple[int, int]]:
        """Edge-balanced contiguous vertex ranges (for distributed loaders)."""
        rdr = self._reader()
        try:
            if hasattr(rdr, "offsets"):
                offs = rdr.offsets()
            else:
                offs = rdr.bit_offsets()  # bit offsets ~ edge mass proxy
        finally:
            rdr.close()
        total = int(offs[-1])
        targets = [(total * (i + 1)) // n_parts for i in range(n_parts)]
        cuts = np.searchsorted(offs, targets, side="left")
        cuts = np.clip(cuts, 1, self.n_vertices)
        bounds = [0] + sorted(set(int(c) for c in cuts))
        if bounds[-1] != self.n_vertices:
            bounds.append(self.n_vertices)
        return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]

    # -- stats / lifecycle -----------------------------------------------------
    @property
    def fs(self) -> Optional[pgfuse.PGFuseFS]:
        """The PG-Fuse mount (None without ``use_pgfuse``).  Auxiliary
        stores (a node-feature store, say) mount here to share the graph's memory budget and readahead
        policy while keeping their own per-file block cache and stats."""
        return self._fs

    def pgfuse_stats(self) -> Optional[pgfuse.PGFuseStats]:
        """Aggregate stats of the whole mount (every file on it)."""
        return self._fs.stats() if self._fs is not None else None

    def pgfuse_file_stats(self) -> Optional[pgfuse.PGFuseStats]:
        """This graph FILE's cache stats only — unlike
        :meth:`pgfuse_stats` these stay attributable to topology traffic
        when auxiliary files (feature stores) share the mount."""
        if self._fs is None:
            return None
        return dataclasses.replace(self._fs.mount(self.path).stats)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._fs is not None:
            if self._owns_fs:
                self._fs.unmount()  # releases every cached block (§III)
            else:
                # shared mount: release only OUR file; other tenants'
                # caches stay warm
                self._fs.unmount(self.path)

    def __enter__(self) -> "GraphHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AsyncRead:
    """In-flight asynchronous load (paper's non-blocking mode)."""

    def __init__(self, g: GraphHandle, partitions: list[tuple[int, int]],
                 callback: Callable[[PartitionBuffer], None], *,
                 n_buffers: int, n_workers: int, raw: bool = False):
        self._g = g
        self._callback = callback
        self._raw = raw
        self._work: "queue.Queue[Optional[tuple[int,int]]]" = queue.Queue()
        self._pool: "queue.Queue[PartitionBuffer]" = queue.Queue()
        for _ in range(max(1, n_buffers)):
            self._pool.put(PartitionBuffer())
        for p in partitions:
            self._work.put(p)
        self._n_left = len(partitions)
        self._done = threading.Event()
        if not partitions:
            self._done.set()
        self._cb_lock = threading.Lock()
        self._err_lock = threading.Lock()
        self._errors: list[BaseException] = []
        self._threads = [
            threading.Thread(target=self._producer, daemon=True,
                             name=f"paragrapher-producer-{i}")
            for i in range(max(1, n_workers))
        ]
        for t in self._threads:
            t.start()

    def _record_error(self, e: BaseException) -> None:
        with self._err_lock:  # producers race here; list.append alone is not
            self._errors.append(e)  # a guaranteed atomic publication point

    def _producer(self) -> None:
        while True:
            try:
                part = self._work.get_nowait()
            except queue.Empty:
                return
            buf = self._pool.get()  # backpressure: wait for a free buffer
            try:
                buf.v0, buf.v1 = part
                if self._raw:
                    offs, packed, b = self._g.read_partition_raw(*part)
                    buf.offsets, buf.packed, buf.b = offs, packed, b
                    buf.neighbors = None
                else:
                    offs, nbrs = self._g.read_partition(*part)
                    buf.offsets, buf.neighbors = offs, nbrs
                    buf.packed = None
                buf.error = None
            except BaseException as e:  # surfaced via wait()
                buf.error = e
                self._record_error(e)
            try:
                with self._cb_lock:
                    self._callback(buf)
            except BaseException as e:
                self._record_error(e)
            finally:
                buf.offsets = buf.neighbors = buf.packed = None  # -> pool
                self._pool.put(buf)
                if self._decr() == 0:
                    self._done.set()

    def _decr(self) -> int:
        with self._cb_lock:
            self._n_left -= 1
            return self._n_left

    def wait(self, timeout: Optional[float] = None) -> None:
        if not self._done.wait(timeout):
            raise TimeoutError("async read did not complete in time")
        with self._err_lock:
            if self._errors:
                raise self._errors[0]

    @property
    def done(self) -> bool:
        return self._done.is_set()


def open_graph(path: Union[str, os.PathLike], *, format: str = "auto",
               use_pgfuse: bool = False,
               pgfuse_block_size: int = pgfuse.DEFAULT_BLOCK_SIZE,
               pgfuse_max_resident_bytes: Optional[int] = None,
               pgfuse_readahead: Optional[int] = None,
               pgfuse_pread_fn=None,
               pgfuse_eviction: str = pgfuse.EVICT_LRU,
               pgfuse_retries: int = 0,
               pgfuse_retry_backoff_s: float = 0.005,
               pgfuse_fs: Optional[pgfuse.PGFuseFS] = None,
               pgfuse_engine=None) -> GraphHandle:
    """Open a graph for loading (the ParaGrapher entry point).

    ``use_pgfuse=True`` mounts the file in the PG-Fuse block cache
    (paper §III); ``format`` is auto-detected from the magic by default.
    ``pgfuse_readahead`` loads that many extra blocks per miss in one
    enlarged request (sequential-scan prefetch for the streaming loader);
    ``pgfuse_pread_fn`` injects a storage backend (benchmarks/tests).
    ``pgfuse_eviction`` picks the replacement policy ("lru" for
    sequential scans, "clock" for random adjacency queries — see
    :func:`repro_torch.core.policy.choose_access_mode`) and ``pgfuse_retries``
    bounds transient-EIO retries per underlying read (deterministic
    ``pgfuse_retry_backoff_s * attempt`` backoff).

    Multi-tenant serving passes ``pgfuse_fs=`` (an existing
    :class:`repro_torch.core.pgfuse.PGFuseFS` several models share — closing
    the handle then unmounts only this graph's file) and optionally
    ``pgfuse_engine=`` (an :class:`repro_torch.core.pgfuse.EngineShare` or its
    name) to claim the file for that tenant's cache share.
    """
    return GraphHandle(
        path, format=format, use_pgfuse=use_pgfuse,
        pgfuse_block_size=pgfuse_block_size,
        pgfuse_max_resident_bytes=pgfuse_max_resident_bytes,
        pgfuse_readahead=pgfuse_readahead,
        pgfuse_pread_fn=pgfuse_pread_fn,
        pgfuse_eviction=pgfuse_eviction,
        pgfuse_retries=pgfuse_retries,
        pgfuse_retry_backoff_s=pgfuse_retry_backoff_s,
        pgfuse_fs=pgfuse_fs,
        pgfuse_engine=pgfuse_engine,
    )


def save_graph(path: Union[str, os.PathLike], csr: CSR, *,
               format: str = FORMAT_COMPBIN, k: int = webgraph.DEFAULT_K) -> int:
    if format == FORMAT_WEBGRAPH:  # k is a WebGraph-only knob
        return webgraph.write_webgraph(path, csr, k)
    return codec.get_codec(format).write(path, csr)
