"""CompBin — compact binary CSR representation (paper §IV).

CompBin stores the ``neighbors`` array of a CSR graph using the *minimum*
number of bytes per vertex ID: for a graph with ``|V|`` vertices it allocates

    b = ceil(log2(|V|) / 8)

bytes per ID (1..8).  Decoding a vertex ID is eq. (1) of the paper::

    id = sum_{i=0}^{b-1} neighbors[(offsets[v]+n)*b + i] << (8*i)

i.e. little-endian byte packing — a handful of shift+add operations, while
preserving O(1) random access into the neighbor list (byte address of the
n-th neighbor of v is ``(offsets[v]+n)*b``).  For ``2^24 <= |V| < 2^32`` the
format degenerates to plain 4-byte binary CSR.

On-disk layout (little-endian):

    +-------------------+----------------------------------------+
    | magic    4 bytes  | b"CBIN"                                |
    | version  u16      | 1                                      |
    | b        u8       | bytes per vertex ID                    |
    | flags    u8       | bit0: neighbors sorted per row         |
    | n_vertices u64    |                                        |
    | n_edges    u64    |                                        |
    +-------------------+----------------------------------------+
    | offsets  (|V|+1) * u64                                     |
    +------------------------------------------------------------+
    | neighbors |E| * b bytes (eq. (1) packing)                  |
    +------------------------------------------------------------+

The header is 24 bytes, so the offsets array begins at ``HEADER_SIZE`` and
the neighbors array at ``HEADER_SIZE + 8*(|V|+1)`` — both fixed, enabling
``mmap()``-style direct access exactly as the paper advertises for binary
CSR.
"""

from __future__ import annotations

import dataclasses
import io
import os
import struct
import threading
from typing import BinaryIO, Optional, Union

import numpy as np

from repro_torch.core.csr import CSR

MAGIC = b"CBIN"
VERSION = 1
HEADER_SIZE = 24
FLAG_SORTED = 1

_HEADER_STRUCT = struct.Struct("<4sHBBQQ")
assert _HEADER_STRUCT.size == HEADER_SIZE

# Process-wide host-decode accounting.  The streaming loader's claim is that
# for CompBin inputs ZERO bytes are decoded on the host (eq. (1) runs in the
# CUDA kernel instead); this counter is how that claim is asserted.
_host_decode_lock = threading.Lock()
_host_decoded_bytes = 0


def host_decoded_bytes() -> int:
    """Total packed bytes decoded BY THE HOST (via :func:`decode_ids`)."""
    with _host_decode_lock:
        return _host_decoded_bytes


def reset_host_decoded_bytes() -> int:
    """Zero the counter; returns the previous value (tests/stats deltas)."""
    global _host_decoded_bytes
    with _host_decode_lock:
        prev, _host_decoded_bytes = _host_decoded_bytes, 0
        return prev


def bytes_per_vertex(n_vertices: int) -> int:
    """``b = ceil(log2(|V|)/8)`` (paper §IV). At least 1, at most 8.

    Computed with INTEGER bit arithmetic over the maximum representable
    id, ``|V| - 1``: the obvious ``math.ceil(math.log2(n) / 8)`` breaks
    at large ``|V|`` where the float rounds — e.g. ``log2(2**56 + 1)``
    rounds to exactly 56.0, yielding b=7 while the max id ``2**56``
    needs 8 bytes, so the encoder crashed on its own header's promise.
    ``(|V|-1).bit_length()`` is exact at every fence.
    """
    if n_vertices < 0:
        raise ValueError("n_vertices must be >= 0")
    return min(8, max(1, (max(n_vertices - 1, 1).bit_length() + 7) // 8))


def encode_ids(ids: np.ndarray, b: int) -> np.ndarray:
    """Pack vertex IDs into ``b`` little-endian bytes each.

    Returns a flat uint8 array of length ``len(ids) * b``.  Vectorized: the
    IDs are viewed as 8 little-endian bytes and the low ``b`` are kept.
    """
    if not 1 <= b <= 8:
        raise ValueError(f"b must be in [1,8], got {b}")
    ids = np.ascontiguousarray(ids, dtype=np.uint64)
    if ids.size and int(ids.max(initial=0)) >= (1 << (8 * b)) and b < 8:
        raise ValueError(f"vertex ID {int(ids.max())} does not fit in {b} bytes")
    # explicit little-endian view: a platform-endianness ``view(np.uint8)``
    # silently wrote byte-swapped ids on big-endian hosts (the wire format
    # is LE by definition — eq. (1) shifts low byte first)
    le = np.ascontiguousarray(ids, dtype="<u8")
    as_bytes = le.view(np.uint8).reshape(-1, 8)
    return np.ascontiguousarray(as_bytes[:, :b]).reshape(-1)


def decode_ids(packed: np.ndarray, b: int) -> np.ndarray:
    """Inverse of :func:`encode_ids` — eq. (1): ``sum(byte_i << 8i)``.

    Vectorized shift+add, mirroring the paper's decoder.  Output dtype is
    uint32 when ``b <= 4`` else uint64.
    """
    if not 1 <= b <= 8:
        raise ValueError(f"b must be in [1,8], got {b}")
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    if packed.size % b:
        raise ValueError(f"packed length {packed.size} not a multiple of b={b}")
    global _host_decoded_bytes
    with _host_decode_lock:
        _host_decoded_bytes += packed.size
    cols = packed.reshape(-1, b)
    out_dtype = np.uint32 if b <= 4 else np.uint64
    acc = np.zeros(cols.shape[0], dtype=out_dtype)
    for i in range(b):  # eq. (1): a few shifts and adds
        acc |= cols[:, i].astype(out_dtype) << out_dtype(8 * i)
    return acc


def compbin_nbytes(n_vertices: int, n_edges: int) -> int:
    """Total on-disk size of a CompBin file (header + offsets + packed IDs)."""
    b = bytes_per_vertex(n_vertices)
    return HEADER_SIZE + 8 * (n_vertices + 1) + b * n_edges


def write_compbin(path_or_file: Union[str, os.PathLike, BinaryIO], csr: CSR,
                  *, sorted_rows: bool = True) -> int:
    """Serialize ``csr`` to CompBin. Returns bytes written."""
    b = bytes_per_vertex(csr.n_vertices)
    header = _HEADER_STRUCT.pack(
        MAGIC, VERSION, b, FLAG_SORTED if sorted_rows else 0,
        csr.n_vertices, csr.n_edges,
    )
    packed = encode_ids(csr.neighbors.astype(np.uint64, copy=False), b)
    offs = csr.offsets.astype("<u8", copy=False)

    own = False
    if isinstance(path_or_file, (str, os.PathLike)):
        f: BinaryIO = open(path_or_file, "wb")
        own = True
    else:
        f = path_or_file
    try:
        n = f.write(header)
        n += f.write(offs.tobytes())
        n += f.write(packed.tobytes())
    finally:
        if own:
            f.close()
    return n


@dataclasses.dataclass
class CompBinHeader:
    b: int
    flags: int
    n_vertices: int
    n_edges: int

    @property
    def offsets_start(self) -> int:
        return HEADER_SIZE

    @property
    def neighbors_start(self) -> int:
        return HEADER_SIZE + 8 * (self.n_vertices + 1)

    @property
    def total_size(self) -> int:
        return self.neighbors_start + self.b * self.n_edges

    # -- the direct-addressing contract (core/codec.py) -------------------
    # These three methods are what makes a header consumable by the
    # random-access query engine without it knowing the codec: byte span
    # of a run of offsets, decode of that span, and the vertex gap that
    # corresponds to a byte merge gap.
    def offsets_span(self, a: int, z: int) -> tuple[int, int]:
        """(byte start, byte length) covering ``offsets[a ..= z+1]``."""
        return self.offsets_start + 8 * a, 8 * (z - a + 2)

    def decode_offsets(self, raw: bytes, a: int, z: int) -> np.ndarray:
        """int64 ``offsets[a ..= z+1]`` from an :meth:`offsets_span` read."""
        return np.frombuffer(raw, dtype="<u8",
                             count=z - a + 2).astype(np.int64)

    def offsets_gap_vertices(self, gap_bytes: int) -> int:
        """How many vertices a byte merge gap spans in the offsets array."""
        return max(1, gap_bytes // 8)


def _file_size(f) -> Optional[int]:
    """Best-effort size of a file-like object (None when undeterminable)."""
    size = getattr(f, "size", None)
    if isinstance(size, int):
        return size
    try:
        pos = f.tell()
        end = f.seek(0, os.SEEK_END)
        f.seek(pos)
        return int(end)
    except (OSError, ValueError, AttributeError):
        return None


def read_header(f) -> CompBinHeader:
    f.seek(0)
    raw = f.read(HEADER_SIZE)
    if len(raw) != HEADER_SIZE:
        raise ValueError("truncated CompBin header")
    magic, version, b, flags, n_v, n_e = _HEADER_STRUCT.unpack(raw)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic!r}; not a CompBin file")
    if version != VERSION:
        raise ValueError(f"unsupported CompBin version {version}")
    # A corrupt header must fail HERE with a clean error, not downstream
    # as a ZeroDivisionError (b=0) or a garbage decode (b>8, impossible
    # sizes): every field the direct-addressing arithmetic divides or
    # seeks by is validated before a single payload byte is trusted.
    hdr = CompBinHeader(b=b, flags=flags, n_vertices=n_v, n_edges=n_e)
    if not 1 <= b <= 8:
        raise IOError(f"corrupt CompBin header: b={b} outside [1, 8]")
    if flags & ~FLAG_SORTED:
        raise IOError(f"corrupt CompBin header: unknown flags 0x{flags:x}")
    actual = _file_size(f)
    if actual is not None and actual < hdr.total_size:
        raise IOError(
            f"corrupt/truncated CompBin file: header promises "
            f"{hdr.total_size} bytes (|V|={n_v}, |E|={n_e}, b={b}) but "
            f"the file holds {actual}")
    return hdr


class CompBinFile:
    """Random-access reader for a CompBin file (paper §IV).

    Works over any file-like object that supports ``seek``/``read`` — in
    particular a PG-Fuse :class:`~repro_torch.core.pgfuse.CachedFile` — so the
    consumer is *unmodified* whether or not the cache is interposed (the
    same independence argument the paper makes for PG-Fuse vs. patching
    WebGraph).
    """

    def __init__(self, file: Union[str, os.PathLike, BinaryIO]):
        if isinstance(file, (str, os.PathLike)):
            self._f: BinaryIO = open(file, "rb")
            self._own = True
        else:
            self._f = file
            self._own = False
        # reads must be positional: the engine's executor calls
        # neighbors_of/read_edge_range concurrently, and an unlocked
        # seek+read pair interleaves (thread A seeks, thread B seeks,
        # thread A reads B's bytes).  Prefer the file's own pread (the
        # PG-Fuse handle has one); otherwise serialize seek+read.
        self._lock = threading.Lock()
        self._pread_fn = getattr(self._f, "pread", None)
        self.header = read_header(self._f)
        self._offsets_cache: Optional[np.ndarray] = None

    def _pread(self, start: int, nbytes: int) -> bytes:
        if self._pread_fn is not None:
            return self._pread_fn(start, nbytes)
        with self._lock:
            self._f.seek(start)
            return self._f.read(nbytes)

    # -- metadata ---------------------------------------------------------
    @property
    def n_vertices(self) -> int:
        return self.header.n_vertices

    @property
    def n_edges(self) -> int:
        return self.header.n_edges

    @property
    def b(self) -> int:
        return self.header.b

    # -- offsets ----------------------------------------------------------
    def offsets(self, v0: int = 0, v1: Optional[int] = None) -> np.ndarray:
        """Read offsets[v0 : v1+1] (inclusive upper fence)."""
        if v1 is None:
            v1 = self.n_vertices
        if self._offsets_cache is not None:
            return self._offsets_cache[v0 : v1 + 1]
        raw = self._pread(self.header.offsets_start + 8 * v0,
                          8 * (v1 - v0 + 1))
        return np.frombuffer(raw, dtype="<u8").astype(np.int64)

    def preload_offsets(self) -> None:
        self._offsets_cache = self.offsets(0, self.n_vertices)

    # -- neighbors --------------------------------------------------------
    def read_edge_range(self, e0: int, e1: int) -> np.ndarray:
        """Decode neighbors[e0:e1] (global edge indices) — eq. (1)."""
        b = self.header.b
        raw = self._pread(self.header.neighbors_start + b * e0, b * (e1 - e0))
        return decode_ids(np.frombuffer(raw, dtype=np.uint8), b)

    def neighbors_of(self, v: int) -> np.ndarray:
        """Direct random access to one adjacency list (the paper's key
        property vs. WebGraph: no sequential decode needed)."""
        offs = self.offsets(v, v + 1)
        return self.read_edge_range(int(offs[0]), int(offs[1]))

    def read_partition(self, v0: int, v1: int) -> tuple[np.ndarray, np.ndarray]:
        """Offsets (rebased to 0) and decoded neighbors for vertices [v0, v1)."""
        offs = self.offsets(v0, v1)
        nbrs = self.read_edge_range(int(offs[0]), int(offs[-1]))
        return (offs - offs[0]).astype(np.int64), nbrs

    def read_full(self) -> CSR:
        offs = self.offsets()
        nbrs = self.read_edge_range(0, self.n_edges)
        dtype = np.int32 if self.n_vertices <= np.iinfo(np.int32).max else np.int64
        return CSR(offsets=offs.astype(np.int64), neighbors=nbrs.astype(dtype))

    def raw_neighbor_bytes(self, e0: int, e1: int) -> np.ndarray:
        """Packed (undecoded) bytes for edges [e0, e1) — fed straight to the
        CUDA decode kernel so the (4-b)/4 bandwidth saving also applies to
        host->HBM traffic and to the kernel's HBM reads (see kernels/compbin_decode)."""
        b = self.header.b
        raw = self._pread(self.header.neighbors_start + b * e0, b * (e1 - e0))
        return np.frombuffer(raw, dtype=np.uint8)

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self) -> "CompBinFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_compbin(path: Union[str, os.PathLike, BinaryIO]) -> CSR:
    """Convenience: load a whole CompBin file into an in-memory CSR."""
    with CompBinFile(path) as f:
        return f.read_full()


def roundtrip_bytes(csr: CSR) -> bytes:
    """Serialize to bytes in memory (tests/benchmarks)."""
    buf = io.BytesIO()
    write_compbin(buf, csr)
    return buf.getvalue()
