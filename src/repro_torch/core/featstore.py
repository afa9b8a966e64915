"""FeatStore — binary node-feature store (the bulk byte stream of GNNs).

For GNN workloads the node-feature matrix, not the topology, is the
dominant byte stream (ogbn-papers100M: ~53 GiB of float16 features vs
~13 GiB of CompBin edges), yet the reproduction so far synthesized
features on the host — bypassing the very storage path the paper
accelerates.  FeatStore closes that gap: a fixed-stride binary row store
read through the SAME PG-Fuse :class:`~repro_torch.core.pgfuse.CachedFile`
layer as CompBin, so enlarged block reads, in-memory caching, and
sequential readahead apply to feature traffic too.

Design mirrors CompBin (paper §IV): no per-row framing, no compression —
the byte address of row ``v`` is ``data_start + v * row_stride``, giving
O(1) random access for sampled minibatches and purely sequential reads
for full-graph streaming.  ``row_stride`` is stored explicitly so padded
strides (e.g. rows rounded up to a cache line) stay decodable, and
``data_start`` is stored explicitly so the writer can align the data
section to the deployment's PG-Fuse block size: with
``data_align == block_size`` and cut vertices that are multiples of
``block_size // row_stride`` (see ``graph.partition.split_plan(align=)``)
neighboring hosts' private caches never fetch the same feature block.

On-disk layout (little-endian):

    +---------------------+------------------------------------------+
    | magic      4 bytes  | b"FSTR"                                  |
    | version    u16      | 1                                        |
    | dtype      u8       | 0=float32, 1=float16, 2=bfloat16, 3=u8   |
    | flags      u8       | reserved (0)                             |
    | n_rows     u64      | number of feature rows (== |V|)          |
    | d          u32      | feature dimension                        |
    | row_stride u32      | bytes per row (>= d * itemsize)          |
    | data_start u64      | byte offset of row 0                     |
    +---------------------+------------------------------------------+
    | zero padding up to data_start                                  |
    +----------------------------------------------------------------+
    | rows: n_rows * row_stride bytes                                |
    +----------------------------------------------------------------+
"""

from __future__ import annotations

import dataclasses
import io
import os
import struct
from typing import BinaryIO, Optional, Union

import numpy as np
import torch

from repro_torch.core import pgfuse

MAGIC = b"FSTR"
VERSION = 1
HEADER_SIZE = 32
#: default data-section alignment; deployments targeting a specific
#: PG-Fuse block size pass ``data_align=block_size`` at write time
DEFAULT_DATA_ALIGN = 64

_HEADER_STRUCT = struct.Struct("<4sHBBQIIQ")
assert _HEADER_STRUCT.size == HEADER_SIZE

#: numpy has no bfloat16: code 2's rows are held as their raw 16-bit
#: patterns in this one-field record dtype (the same bytes on disk as the
#: JAX package's bfloat16 rows); a tensor views them as
#: ``torch.bfloat16`` (:func:`rows_to_tensor`)
BF16_BITS = np.dtype([("bfloat16", "<u2")])

#: dtype codes are part of the wire format — append only, never renumber
DTYPE_CODES = {0: np.dtype(np.float32), 1: np.dtype(np.float16),
               2: BF16_BITS, 3: np.dtype(np.uint8)}
_CODE_FOR_DTYPE = {v: k for k, v in DTYPE_CODES.items()}


def rows_to_tensor(rows: np.ndarray) -> torch.Tensor:
    """Rows read from a store as a CPU tensor sharing their memory;
    bfloat16 rows (:data:`BF16_BITS`) as ``torch.bfloat16``."""
    if rows.dtype == BF16_BITS:
        return torch.from_numpy(rows.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(rows)


def dtype_code(dtype) -> int:
    dt = np.dtype(dtype)
    if dt not in _CODE_FOR_DTYPE:
        raise ValueError(f"unsupported feature dtype {dt} "
                         f"(supported: {sorted(map(str, _CODE_FOR_DTYPE))})")
    return _CODE_FOR_DTYPE[dt]


@dataclasses.dataclass
class FeatStoreHeader:
    dtype: np.dtype
    flags: int
    n_rows: int
    d: int
    row_stride: int
    data_start: int

    @property
    def row_bytes(self) -> int:
        """Payload bytes per row (<= row_stride when rows are padded)."""
        return self.d * self.dtype.itemsize

    @property
    def total_size(self) -> int:
        return self.data_start + self.n_rows * self.row_stride


def featstore_nbytes(n_rows: int, d: int, dtype=np.float32, *,
                     data_align: int = DEFAULT_DATA_ALIGN) -> int:
    """Total on-disk size of a FeatStore file (header + padding + rows)."""
    stride = d * np.dtype(dtype).itemsize
    start = _aligned_data_start(data_align)
    return start + n_rows * stride


def _aligned_data_start(data_align: int) -> int:
    if data_align < 1:
        raise ValueError(f"data_align must be >= 1, got {data_align}")
    return -(-HEADER_SIZE // data_align) * data_align


def write_featstore(path_or_file: Union[str, os.PathLike, BinaryIO],
                    x: np.ndarray, *, dtype=None,
                    data_align: int = DEFAULT_DATA_ALIGN) -> int:
    """Serialize feature matrix ``x`` (n_rows, d). Returns bytes written.

    ``data_align`` pads the data section start to a multiple of the given
    byte count; pass the deployment's PG-Fuse block size so per-host row
    ranges can be made block-disjoint (see module docstring).
    """
    x = np.asarray(x)
    if x.ndim != 2:
        raise ValueError(f"features must be 2-D (n_rows, d), got {x.shape}")
    if dtype is not None:
        x = x.astype(dtype, copy=False)
    code = dtype_code(x.dtype)
    n_rows, d = x.shape
    stride = d * x.dtype.itemsize
    data_start = _aligned_data_start(data_align)
    header = _HEADER_STRUCT.pack(MAGIC, VERSION, code, 0, n_rows, d,
                                 stride, data_start)

    own = False
    if isinstance(path_or_file, (str, os.PathLike)):
        f: BinaryIO = open(path_or_file, "wb")
        own = True
    else:
        f = path_or_file
    try:
        n = f.write(header)
        n += f.write(b"\0" * (data_start - HEADER_SIZE))
        n += f.write(np.ascontiguousarray(x).tobytes())
    finally:
        if own:
            f.close()
    return n


def read_header(f) -> FeatStoreHeader:
    f.seek(0)
    raw = f.read(HEADER_SIZE)
    if len(raw) != HEADER_SIZE:
        raise ValueError("truncated FeatStore header")
    magic, version, code, flags, n_rows, d, stride, start = \
        _HEADER_STRUCT.unpack(raw)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic!r}; not a FeatStore file")
    if version != VERSION:
        raise ValueError(f"unsupported FeatStore version {version}")
    if code not in DTYPE_CODES:
        raise ValueError(f"unknown FeatStore dtype code {code}")
    dt = DTYPE_CODES[code]
    if stride < d * dt.itemsize:
        raise ValueError(f"row_stride {stride} < row payload {d * dt.itemsize}")
    if start < HEADER_SIZE:
        raise ValueError(f"data_start {start} overlaps the header")
    return FeatStoreHeader(dtype=dt, flags=flags, n_rows=n_rows, d=d,
                           row_stride=stride, data_start=start)


class FeatStoreFile:
    """Row reader over any ``seek``/``read`` file-like object.

    Like :class:`repro_torch.core.compbin.CompBinFile`, the consumer is
    unmodified whether it reads the real filesystem or a PG-Fuse
    :class:`~repro_torch.core.pgfuse.CachedFileHandle` — the paper's
    independence argument carries over to feature traffic.
    """

    def __init__(self, file: Union[str, os.PathLike, BinaryIO]):
        if isinstance(file, (str, os.PathLike)):
            self._f: BinaryIO = open(file, "rb")
            self._own = True
        else:
            self._f = file
            self._own = False
        self.header = read_header(self._f)

    @property
    def n_rows(self) -> int:
        return self.header.n_rows

    @property
    def d(self) -> int:
        return self.header.d

    @property
    def dtype(self) -> np.dtype:
        return self.header.dtype

    def read_rows(self, v0: int, v1: int) -> np.ndarray:
        """Feature rows [v0, v1) as an (v1-v0, d) array.

        A short read raises ``IOError`` — truncated feature rows must
        surface exactly like truncated CompBin blocks do (silent zero
        padding would train on corrupt features without a trace).
        """
        h = self.header
        if not 0 <= v0 <= v1 <= h.n_rows:
            raise ValueError(f"bad row range [{v0},{v1}) for {h.n_rows} rows")
        n = v1 - v0
        if n == 0:
            return np.zeros((0, h.d), dtype=h.dtype)
        self._f.seek(h.data_start + v0 * h.row_stride)
        want = n * h.row_stride
        raw = self._f.read(want)
        if len(raw) < want:
            raise IOError(f"short read of feature rows [{v0},{v1}): got "
                          f"{len(raw)} of {want} bytes")
        rows = np.frombuffer(raw, dtype=np.uint8).reshape(n, h.row_stride)
        return rows[:, :h.row_bytes].copy().view(h.dtype).reshape(n, h.d)

    def read_full(self) -> np.ndarray:
        return self.read_rows(0, self.n_rows)

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self) -> "FeatStoreFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class FeatureStoreHandle:
    """An open feature store; the feature-side sibling of ``GraphHandle``.

    Thread-safe the same way: every read opens its own file handle over
    the shared block cache.  Pass ``fs=graph.fs`` to mount the store into
    an already-open graph's PG-Fuse instance — one memory budget, one
    readahead policy, separate per-file block caches and stats (so
    feature and topology traffic stay individually attributable).
    """

    def __init__(self, path: Union[str, os.PathLike], *,
                 fs: Optional[pgfuse.PGFuseFS] = None,
                 use_pgfuse: bool = False,
                 pgfuse_block_size: int = pgfuse.DEFAULT_BLOCK_SIZE,
                 pgfuse_max_resident_bytes: Optional[int] = None,
                 pgfuse_readahead: int = 0,
                 pgfuse_pread_fn=None,
                 pgfuse_file_budget: Optional[int] = None,
                 pgfuse_file_readahead: Optional[int] = None,
                 pgfuse_engine=None):
        self.path = os.fspath(path)
        self._owns_fs = False
        self._fs = fs
        if fs is None and use_pgfuse:
            self._fs = pgfuse.PGFuseFS(
                block_size=pgfuse_block_size,
                max_resident_bytes=pgfuse_max_resident_bytes,
                readahead=pgfuse_readahead,
                pread_fn=pgfuse_pread_fn)
            self._owns_fs = True
        self._cf: Optional[pgfuse.CachedFile] = None
        if self._fs is not None:
            # ``pgfuse_file_budget`` caps THIS store's share of the shared
            # mount (so feature churn cannot evict the graph's hot offset
            # blocks), ``pgfuse_file_readahead`` overrides the mount's
            # readahead for this file only (0 for random row gathers),
            # and ``pgfuse_engine`` claims the store for one tenant's
            # EngineShare on a multi-model mount
            self._cf = self._fs.mount(
                self.path, max_resident_bytes=pgfuse_file_budget,
                readahead=pgfuse_file_readahead, engine=pgfuse_engine)
            if not self._owns_fs:
                # shared mount: refcounted like GraphHandle, so two
                # handles over the SAME store (model replicas) can close
                # independently without dropping each other's cache
                self._fs.retain(self.path)
        self._closed = False
        try:
            rdr = self._reader()  # validates the header eagerly
            self.header = rdr.header
            self.n_rows = rdr.n_rows
            self.d = rdr.d
            self.dtype = rdr.dtype
            rdr.close()
        except BaseException:
            # unwind the mount on a failed open (mirrors GraphHandle):
            # otherwise the retain/share membership leaks handle-less
            if self._fs is not None:
                if self._owns_fs:
                    self._fs.unmount()
                else:
                    self._fs.unmount(self.path)
            raise

    @property
    def cached_file(self) -> Optional[pgfuse.CachedFile]:
        """The store's own PG-Fuse block cache (None when unmounted)."""
        return self._cf

    def _reader(self) -> FeatStoreFile:
        if self._cf is not None:
            return FeatStoreFile(self._cf.open())
        return FeatStoreFile(open(self.path, "rb"))

    def read_rows(self, v0: int, v1: int) -> np.ndarray:
        if self._closed:
            raise ValueError("read on closed feature store")
        rdr = self._reader()
        try:
            return rdr.read_rows(v0, v1)
        finally:
            rdr.close()

    def pgfuse_stats(self) -> Optional[pgfuse.PGFuseStats]:
        """This FILE's cache stats (not the whole mount's aggregate)."""
        if self._cf is None:
            return None
        return dataclasses.replace(self._cf.stats)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._fs is not None:
            if self._owns_fs:
                self._fs.unmount()
            else:
                # release OUR retain of this store's file; the shared fs
                # itself is owned by whoever created it, and the file
                # truly unmounts only when its last retainer closes
                self._fs.unmount(self.path)

    def __enter__(self) -> "FeatureStoreHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_featstore(path: Union[str, os.PathLike], **kwargs
                   ) -> FeatureStoreHandle:
    """Open a feature store (see :class:`FeatureStoreHandle`)."""
    return FeatureStoreHandle(path, **kwargs)


def read_featstore(path: Union[str, os.PathLike, BinaryIO]) -> np.ndarray:
    """Convenience: load a whole store into one (n_rows, d) array."""
    with FeatStoreFile(path) as f:
        return f.read_full()


def roundtrip_bytes(x: np.ndarray, **kwargs) -> bytes:
    """Serialize to bytes in memory (tests/benchmarks)."""
    buf = io.BytesIO()
    write_featstore(buf, x, **kwargs)
    return buf.getvalue()
