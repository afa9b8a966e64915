"""Pluggable on-disk graph codecs — one contract, many encodings.

This module is the seam the locality-ordering graph compiler
(src/repro/graph/reorder.py) re-encodes through: every codec registers a
:class:`CodecSpec` here, and `GraphHandle`, `NeighborQueryEngine` and
`GraphStream` consume *any* registered codec through the same surface
instead of hardcoding CompBin.

The **direct-addressing contract** (``CodecSpec.direct = True``) is what
the random-access paths require of a reader ``spec.open(file)``:

* metadata: ``n_vertices``, ``n_edges``, ``b`` (bytes per packed
  neighbor id), ``header`` with ``neighbors_start`` / ``total_size``;
* offsets addressing on the header: ``offsets_span(a, z)`` -> byte span
  covering ``offsets[a ..= z+1]``, ``decode_offsets(raw, a, z)`` ->
  int64 array, ``offsets_gap_vertices(gap_bytes)`` -> merge-gap width;
* neighbors: byte-packed little-endian ids of fixed width ``b`` at
  ``neighbors_start`` (eq. (1) packing), so the byte address of the
  n-th neighbor of v is ``neighbors_start + (offsets[v] + n) * b`` and
  ONE CUDA decode kernel (kernels/compbin_decode) serves every direct
  codec;
* reads: ``offsets(v0, v1)``, ``read_edge_range``, ``neighbors_of``,
  ``read_partition``, ``read_full``, ``raw_neighbor_bytes``, ``close``
  — all safe to call concurrently (positional reads).

Sequential codecs (``direct = False``, e.g. WebGraph's bit-level gamma/
zeta codes) only promise the loading surface (``read_partition`` /
``read_full`` / ``neighbors_of`` / ``bit_offsets``); the query engine
rejects them.

The second direct codec implemented here, **LogCSR**, applies the
Log(Graph) idea (PAPERS.md) to the offsets array: offsets are stored
bit-packed at ``obits = max(1, ceil(log2(|E|+1)))`` bits per entry
instead of CompBin's fixed 8 bytes, while neighbors keep the exact
CompBin byte packing.  On-disk layout (little-endian)::

    +---------------------+--------------------------------------+
    | magic      4 bytes  | b"LGSR"                              |
    | version    u16      | 1                                    |
    | b          u8       | bytes per neighbor id (CompBin rule) |
    | obits      u8       | bits per offsets entry (1..57 or 64) |
    | flags      u8       | bit0: neighbors sorted per row       |
    | pad        3 bytes  | zero                                 |
    | n_vertices u64      |                                      |
    | n_edges    u64      |                                      |
    | offsets_nbytes u64  | bit-packed size incl. 8 guard bytes  |
    +---------------------+--------------------------------------+
    | offsets   ceil((|V|+1)*obits/8) bytes + 8 zero guard bytes |
    +------------------------------------------------------------+
    | neighbors |E| * b bytes (eq. (1) packing, as CompBin)      |
    +------------------------------------------------------------+

Entry ``i`` occupies bits ``[i*obits, (i+1)*obits)`` of the offsets
section, LSB-first within the little-endian byte stream.  The 8 guard
bytes let the reader decode any entry with one unaligned 8-byte window
load (``value = window >> (bit & 7) & mask``), which is why ``obits``
is capped: any width that would straddle more than 64 bits after the
worst-case 7-bit shift (58..63) is rounded up to 64 (plain ``<u8``,
i.e. CompBin-shaped offsets).  For web-scale graphs ``obits`` ~ 35-40,
a ~2x offsets-section saving over CompBin.
"""

from __future__ import annotations

import dataclasses
import io
import os
import struct
import threading
from typing import BinaryIO, Callable, Optional, Union

import numpy as np

from repro_torch.core import compbin, webgraph
from repro_torch.core.csr import CSR

# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """One registered on-disk codec.

    ``write(path_or_file, csr) -> bytes_written`` serializes;
    ``open(file_like) -> reader`` returns the codec's reader (validating
    the header eagerly); ``direct`` declares the direct-addressing
    contract above (a requirement of the query engine and the raw
    device-decode streaming path); ``suffix`` is the conventional file
    extension (golden fixtures, the compile_graph CLI); ``nbytes``
    predicts the on-disk size of a CSR without encoding it (None when
    only encoding can tell, e.g. entropy-coded formats).
    """

    name: str
    magic: bytes
    suffix: str
    direct: bool
    write: Callable[..., int]
    open: Callable[[Union[str, os.PathLike, BinaryIO]], object]
    nbytes: Optional[Callable[[int, int], int]] = None


_registry: dict[str, CodecSpec] = {}
_by_magic: dict[bytes, CodecSpec] = {}


def register_codec(spec: CodecSpec) -> CodecSpec:
    """Add ``spec`` to the registry (idempotent per name+magic)."""
    if len(spec.magic) != 4:
        raise ValueError(f"codec magic must be 4 bytes, got {spec.magic!r}")
    prev = _registry.get(spec.name)
    if prev is not None and prev.magic != spec.magic:
        raise ValueError(f"codec {spec.name!r} already registered "
                         f"with magic {prev.magic!r}")
    _registry[spec.name] = spec
    _by_magic[spec.magic] = spec
    return spec


def get_codec(name: str) -> CodecSpec:
    try:
        return _registry[name]
    except KeyError:
        raise ValueError(f"unknown codec {name!r}; registered: "
                         f"{', '.join(sorted(_registry))}") from None


def codec_for_magic(magic: bytes) -> Optional[CodecSpec]:
    """The codec owning a 4-byte magic, or None."""
    return _by_magic.get(bytes(magic[:4]))


def registered_codecs() -> dict[str, CodecSpec]:
    return dict(sorted(_registry.items()))


def direct_codecs() -> list[str]:
    """Names of codecs honoring the direct-addressing contract."""
    return [n for n, s in sorted(_registry.items()) if s.direct]


# ---------------------------------------------------------------------------
# LogCSR — bit-packed offsets, CompBin-packed neighbors
# ---------------------------------------------------------------------------

LOGCSR_MAGIC = b"LGSR"
LOGCSR_VERSION = 1
LOGCSR_HEADER_SIZE = 36
_LOGCSR_STRUCT = struct.Struct("<4sHBBB3xQQQ")
assert _LOGCSR_STRUCT.size == LOGCSR_HEADER_SIZE
_GUARD_BYTES = 8  # lets any entry be read with one 8-byte window load


def offset_bits(n_edges: int) -> int:
    """Bits per offsets entry: enough for the largest value (``|E|``),
    capped so a 7-bit-shifted window load never straddles 64 bits —
    widths 58..63 round up to the byte-aligned 64."""
    if n_edges < 0:
        raise ValueError("n_edges must be >= 0")
    obits = max(1, int(n_edges).bit_length())
    return 64 if obits > 57 else obits


def packed_offsets_nbytes(n_vertices: int, obits: int) -> int:
    """On-disk bytes of the bit-packed offsets section, guard included."""
    return ((n_vertices + 1) * obits + 7) // 8 + _GUARD_BYTES


def pack_offsets(offsets: np.ndarray, obits: int) -> bytes:
    """Bit-pack ``offsets`` LSB-first at ``obits`` bits per entry."""
    vals = np.ascontiguousarray(offsets, dtype=np.uint64)
    if vals.size and int(vals.max()) >= (1 << obits) and obits < 64:
        raise ValueError(f"offset {int(vals.max())} does not fit "
                         f"in {obits} bits")
    if obits == 64:
        return vals.astype("<u8").tobytes() + b"\0" * _GUARD_BYTES
    nbytes = (vals.size * obits + 7) // 8 + _GUARD_BYTES
    buf = np.zeros(nbytes, dtype=np.uint8)
    bit = np.arange(vals.size, dtype=np.int64) * obits
    byte, shift = bit >> 3, (bit & 7).astype(np.uint64)
    # each shifted entry fits one u64 (obits <= 57, shift <= 7): spread
    # its 8 LE bytes and OR them in place (entries may share bytes)
    chunk = vals << shift
    lanes = np.arange(8, dtype=np.uint64)
    chunk_bytes = ((chunk[:, None] >> (8 * lanes)) & np.uint64(0xFF)
                   ).astype(np.uint8)
    np.bitwise_or.at(buf, byte[:, None] + np.arange(8), chunk_bytes)
    return buf.tobytes()


def unpack_offsets(raw: bytes, obits: int, first_bit: int,
                   count: int) -> np.ndarray:
    """Decode ``count`` entries whose first entry starts at ``first_bit``
    relative to ``raw`` (which must extend 8 bytes past the start byte
    of the last entry — the guard guarantee)."""
    u8 = np.frombuffer(raw, dtype=np.uint8)
    bit = first_bit + np.arange(count, dtype=np.int64) * obits
    byte, shift = bit >> 3, (bit & 7).astype(np.uint64)
    win = np.ascontiguousarray(
        u8[byte[:, None] + np.arange(8)]).view("<u8")[:, 0]
    vals = win >> shift
    if obits < 64:
        vals = vals & np.uint64((1 << obits) - 1)
    return vals.astype(np.int64)


@dataclasses.dataclass
class LogCSRHeader:
    b: int
    obits: int
    flags: int
    n_vertices: int
    n_edges: int
    offsets_nbytes: int

    @property
    def offsets_start(self) -> int:
        return LOGCSR_HEADER_SIZE

    @property
    def neighbors_start(self) -> int:
        return LOGCSR_HEADER_SIZE + self.offsets_nbytes

    @property
    def total_size(self) -> int:
        return self.neighbors_start + self.b * self.n_edges

    # -- the direct-addressing contract ------------------------------------
    def offsets_span(self, a: int, z: int) -> tuple[int, int]:
        """(byte start, byte length) covering ``offsets[a ..= z+1]``.

        The span always reaches 8 bytes past the LAST entry's start byte
        so :func:`unpack_offsets` can window-load it; the file's guard
        bytes keep that in-bounds even at ``z + 1 == n_vertices``.
        """
        start = self.offsets_start + ((a * self.obits) >> 3)
        last_start = self.offsets_start + (((z + 1) * self.obits) >> 3)
        return start, last_start + 8 - start

    def decode_offsets(self, raw: bytes, a: int, z: int) -> np.ndarray:
        first_bit = a * self.obits - 8 * ((a * self.obits) >> 3)
        return unpack_offsets(raw, self.obits, first_bit, z - a + 2)

    def offsets_gap_vertices(self, gap_bytes: int) -> int:
        return max(1, (8 * gap_bytes) // self.obits)


def logcsr_nbytes(n_vertices: int, n_edges: int) -> int:
    """Total on-disk size of a LogCSR file."""
    obits = offset_bits(n_edges)
    return (LOGCSR_HEADER_SIZE + packed_offsets_nbytes(n_vertices, obits)
            + compbin.bytes_per_vertex(n_vertices) * n_edges)


def write_logcsr(path_or_file: Union[str, os.PathLike, BinaryIO], csr: CSR,
                 *, sorted_rows: bool = True) -> int:
    """Serialize ``csr`` to LogCSR. Returns bytes written."""
    b = compbin.bytes_per_vertex(csr.n_vertices)
    obits = offset_bits(csr.n_edges)
    packed_offs = pack_offsets(csr.offsets, obits)
    header = _LOGCSR_STRUCT.pack(
        LOGCSR_MAGIC, LOGCSR_VERSION, b, obits,
        compbin.FLAG_SORTED if sorted_rows else 0,
        csr.n_vertices, csr.n_edges, len(packed_offs))
    packed_ids = compbin.encode_ids(
        csr.neighbors.astype(np.uint64, copy=False), b)

    own = False
    if isinstance(path_or_file, (str, os.PathLike)):
        f: BinaryIO = open(path_or_file, "wb")
        own = True
    else:
        f = path_or_file
    try:
        n = f.write(header)
        n += f.write(packed_offs)
        n += f.write(packed_ids.tobytes())
    finally:
        if own:
            f.close()
    return n


def read_logcsr_header(f) -> LogCSRHeader:
    f.seek(0)
    raw = f.read(LOGCSR_HEADER_SIZE)
    if len(raw) != LOGCSR_HEADER_SIZE:
        raise ValueError("truncated LogCSR header")
    magic, version, b, obits, flags, n_v, n_e, off_nb = \
        _LOGCSR_STRUCT.unpack(raw)
    if magic != LOGCSR_MAGIC:
        raise ValueError(f"bad magic {magic!r}; not a LogCSR file")
    if version != LOGCSR_VERSION:
        raise ValueError(f"unsupported LogCSR version {version}")
    # same hardening rule as CompBin's read_header: every field the
    # addressing arithmetic trusts is validated before any payload read
    if not 1 <= b <= 8:
        raise IOError(f"corrupt LogCSR header: b={b} outside [1, 8]")
    if not (1 <= obits <= 57 or obits == 64):
        raise IOError(f"corrupt LogCSR header: obits={obits} "
                      f"outside [1, 57] u {{64}}")
    if flags & ~compbin.FLAG_SORTED:
        raise IOError(f"corrupt LogCSR header: unknown flags 0x{flags:x}")
    if off_nb != packed_offsets_nbytes(n_v, obits):
        raise IOError(
            f"corrupt LogCSR header: offsets_nbytes={off_nb}, expected "
            f"{packed_offsets_nbytes(n_v, obits)} for |V|={n_v}, "
            f"obits={obits}")
    hdr = LogCSRHeader(b=b, obits=obits, flags=flags, n_vertices=n_v,
                       n_edges=n_e, offsets_nbytes=off_nb)
    actual = compbin._file_size(f)
    if actual is not None and actual < hdr.total_size:
        raise IOError(
            f"corrupt/truncated LogCSR file: header promises "
            f"{hdr.total_size} bytes (|V|={n_v}, |E|={n_e}, b={b}, "
            f"obits={obits}) but the file holds {actual}")
    return hdr


class LogCSRFile:
    """Random-access LogCSR reader — same surface as
    :class:`repro_torch.core.compbin.CompBinFile` (the direct-addressing
    contract), different offsets decode."""

    def __init__(self, file: Union[str, os.PathLike, BinaryIO]):
        if isinstance(file, (str, os.PathLike)):
            self._f: BinaryIO = open(file, "rb")
            self._own = True
        else:
            self._f = file
            self._own = False
        self._lock = threading.Lock()
        self._pread_fn = getattr(self._f, "pread", None)
        self.header = read_logcsr_header(self._f)
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
        start, nbytes = self.header.offsets_span(v0, v1 - 1)
        raw = self._pread(start, nbytes)
        return self.header.decode_offsets(raw, v0, v1 - 1)

    def preload_offsets(self) -> None:
        self._offsets_cache = self.offsets(0, self.n_vertices)

    # -- neighbors (identical byte packing to CompBin) --------------------
    def read_edge_range(self, e0: int, e1: int) -> np.ndarray:
        """Decode neighbors[e0:e1] (global edge indices) — eq. (1)."""
        b = self.header.b
        raw = self._pread(self.header.neighbors_start + b * e0,
                          b * (e1 - e0))
        return compbin.decode_ids(np.frombuffer(raw, dtype=np.uint8), b)

    def neighbors_of(self, v: int) -> np.ndarray:
        offs = self.offsets(v, v + 1)
        return self.read_edge_range(int(offs[0]), int(offs[1]))

    def read_partition(self, v0: int, v1: int
                       ) -> tuple[np.ndarray, np.ndarray]:
        offs = self.offsets(v0, v1)
        nbrs = self.read_edge_range(int(offs[0]), int(offs[-1]))
        return (offs - offs[0]).astype(np.int64), nbrs

    def read_full(self) -> CSR:
        offs = self.offsets()
        nbrs = self.read_edge_range(0, self.n_edges)
        dtype = np.int32 if self.n_vertices <= np.iinfo(np.int32).max \
            else np.int64
        return CSR(offsets=offs.astype(np.int64),
                   neighbors=nbrs.astype(dtype))

    def raw_neighbor_bytes(self, e0: int, e1: int) -> np.ndarray:
        """Packed (undecoded) bytes for edges [e0, e1) — decodable by the
        same CUDA kernel as CompBin's stream (identical packing)."""
        b = self.header.b
        raw = self._pread(self.header.neighbors_start + b * e0,
                          b * (e1 - e0))
        return np.frombuffer(raw, dtype=np.uint8)

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self) -> "LogCSRFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_logcsr(path: Union[str, os.PathLike, BinaryIO]) -> CSR:
    """Convenience: load a whole LogCSR file into an in-memory CSR."""
    with LogCSRFile(path) as f:
        return f.read_full()


def logcsr_roundtrip_bytes(csr: CSR) -> bytes:
    """Serialize to bytes in memory (tests/benchmarks)."""
    buf = io.BytesIO()
    write_logcsr(buf, csr)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# the built-in codecs
# ---------------------------------------------------------------------------

COMPBIN = register_codec(CodecSpec(
    name="compbin", magic=compbin.MAGIC, suffix="cbin", direct=True,
    write=compbin.write_compbin, open=compbin.CompBinFile,
    nbytes=compbin.compbin_nbytes))

LOGCSR = register_codec(CodecSpec(
    name="logcsr", magic=LOGCSR_MAGIC, suffix="lgsr", direct=True,
    write=write_logcsr, open=LogCSRFile, nbytes=logcsr_nbytes))

WEBGRAPH = register_codec(CodecSpec(
    name="webgraph", magic=webgraph.MAGIC, suffix="wg", direct=False,
    write=webgraph.write_webgraph, open=webgraph.WebGraphFile))
