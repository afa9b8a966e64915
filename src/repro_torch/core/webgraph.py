"""WebGraph-style compressed graph codec (paper §II-A baseline).

A faithful-in-spirit reimplementation of the Boldi–Vigna WebGraph format
[WWW'04] used by ParaGrapher as its input format: per-vertex successor lists
with **gap encoding** and instantaneous codes —

  * outdegree ``d``            -> gamma(d + 1)
  * first gap ``n0 - v``       -> zigzag to a natural, then zeta_k(nat + 1)
  * following gaps ``n_i - n_{i-1} - 1`` -> zeta_k(gap + 1)

with neighbors sorted ascending per row.  ``zeta_k`` (default k=3, the
WebGraph default) is the Boldi–Vigna zeta code: unary(h+1) followed by the
minimal-binary code of ``x - 2^{hk}`` in an interval of size
``2^{(h+1)k} - 2^{hk}``, where ``h = floor(floor(log2 x) / k)``.

Simplification vs. the Java WebGraph (recorded in DESIGN.md): we omit the
reference/copy-list and interval machinery, keeping only gaps + zeta codes.
Compression ratios are therefore lower than real WebGraph, but the format
retains the property the paper studies: decoding is *sequential and
compute-bound* (bit-level unary scans + table-free minimal binary), in
contrast to CompBin's O(1) byte-aligned shift+add access.

On-disk layout (little-endian):

    magic b"WGPH" | version u16 | k u8 | flags u8 | n_vertices u64 | n_edges u64
    bit_offsets  (|V|+1) * u64   (bit position of each vertex's first code,
                                  relative to the data section; last entry =
                                  total bit length)
    data          packed bits (MSB-first within each byte)

Two decoders are provided:

  * :class:`BitReader` — scalar sequential reference decoder (oracle for
    tests, and the per-vertex random-access path).
  * wavefront decode (:meth:`WebGraphFile.read_full`) — decodes one code
    per *round* across all requested vertices simultaneously with numpy,
    giving vectorized whole-graph loads.  Round count = max degree + 1.
"""

from __future__ import annotations

import dataclasses
import io
import os
import struct
from typing import BinaryIO, Optional, Union

import numpy as np

from repro_torch.core.csr import CSR

MAGIC = b"WGPH"
VERSION = 1
HEADER_SIZE = 24
_HEADER_STRUCT = struct.Struct("<4sHBBQQ")
assert _HEADER_STRUCT.size == HEADER_SIZE

DEFAULT_K = 3


# ---------------------------------------------------------------------------
# zigzag (WebGraph nat2int/int2nat) for the v-relative first gap
# ---------------------------------------------------------------------------

def int2nat(x: np.ndarray) -> np.ndarray:
    """Signed -> natural: 0,-1,1,-2,2,... -> 0,1,2,3,4,..."""
    x = np.asarray(x, dtype=np.int64)
    return np.where(x >= 0, 2 * x, -2 * x - 1).astype(np.uint64)


def nat2int(n: np.ndarray) -> np.ndarray:
    n = np.asarray(n, dtype=np.uint64).astype(np.int64)
    return np.where(n % 2 == 0, n // 2, -(n + 1) // 2)


# ---------------------------------------------------------------------------
# code tables: (pattern, nbits) for gamma / zeta_k, vectorized
# ---------------------------------------------------------------------------

def _floor_log2(x: np.ndarray) -> np.ndarray:
    """floor(log2 x) for x >= 1 (uint64-safe)."""
    x = np.asarray(x, dtype=np.uint64)
    if np.any(x < 1):
        raise ValueError("codes are defined for x >= 1")
    out = np.zeros(x.shape, dtype=np.int64)
    v = x.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        big = v >= (np.uint64(1) << np.uint64(shift))
        out += np.where(big, shift, 0)
        v = np.where(big, v >> np.uint64(shift), v)
    return out


def gamma_code(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """gamma(x), x>=1: L zeros then the (L+1)-bit binary of x (MSB first).

    Returned as (pattern, nbits) with the zeros implicit in the MSB-aligned
    pattern (pattern == x, nbits == 2L+1).
    """
    x = np.asarray(x, dtype=np.uint64)
    L = _floor_log2(x)
    return x, (2 * L + 1)


def _minimal_binary_params(z: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(s, t) for minimal binary coding of [0, z): s=ceil(log2 z), t=2^s-z."""
    z = np.asarray(z, dtype=np.uint64)
    s = _floor_log2(z)
    s = np.where((np.uint64(1) << s.astype(np.uint64)) < z, s + 1, s)
    t = (np.uint64(1) << s.astype(np.uint64)) - z
    return s, t


def zeta_code(x: np.ndarray, k: int = DEFAULT_K) -> tuple[np.ndarray, np.ndarray]:
    """Boldi–Vigna zeta_k(x), x>=1 -> (pattern, nbits), MSB-aligned."""
    x = np.asarray(x, dtype=np.uint64)
    h = _floor_log2(x) // k
    hk = (h * k).astype(np.uint64)
    lo = np.uint64(1) << hk                      # 2^{hk}
    z = (np.uint64(1) << (hk + np.uint64(k))) - lo  # interval size
    s, t = _minimal_binary_params(z)
    m = x - lo
    short = m < t
    mb_bits = np.where(short, s - 1, s)
    mb_val = np.where(short, m, m + t)
    # unary(h+1): h zeros then a 1 -> pattern 1 in (h+1) bits, then the mb code
    nbits = (h + 1) + mb_bits
    pattern = (np.uint64(1) << mb_bits.astype(np.uint64)) | mb_val
    if np.any(nbits > 64):
        raise ValueError("zeta codeword exceeds 64 bits")
    return pattern, nbits


# ---------------------------------------------------------------------------
# bit packing: many (pattern, nbits) codes -> one packed bitstream
# ---------------------------------------------------------------------------

def pack_codes(patterns: np.ndarray, nbits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate MSB-aligned codewords into a packed bit array.

    Returns (packed_bytes uint8, bit_starts int64[len+1]).  O(max nbits)
    vectorized passes.
    """
    patterns = np.asarray(patterns, dtype=np.uint64)
    nbits = np.asarray(nbits, dtype=np.int64)
    starts = np.zeros(len(nbits) + 1, dtype=np.int64)
    np.cumsum(nbits, out=starts[1:])
    total = int(starts[-1])
    bits = np.zeros(total, dtype=np.uint8)
    maxb = int(nbits.max(initial=0))
    for j in range(maxb):
        sel = nbits > j
        pos = starts[:-1][sel] + j
        shift = (nbits[sel] - 1 - j).astype(np.uint64)
        bits[pos] = ((patterns[sel] >> shift) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits), starts


# ---------------------------------------------------------------------------
# scalar sequential decoder (reference oracle + random access)
# ---------------------------------------------------------------------------

class BitReader:
    """Sequential bit reader over an unpacked 0/1 uint8 array."""

    def __init__(self, bits: np.ndarray, pos: int = 0):
        self.bits = bits
        self.pos = pos
        # positions of set bits, for O(log) unary scans
        self._ones = np.flatnonzero(bits).astype(np.int64)

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        chunk = self.bits[self.pos : self.pos + n]
        self.pos += n
        v = 0
        for bit in chunk:
            v = (v << 1) | int(bit)
        return v

    def _zeros_run(self) -> int:
        i = np.searchsorted(self._ones, self.pos)
        if i >= len(self._ones):
            raise EOFError("ran off the bitstream in a unary scan")
        nxt = int(self._ones[i])
        run = nxt - self.pos
        self.pos = nxt + 1  # consume the terminating 1
        return run

    def read_gamma(self) -> int:
        L = self._zeros_run()
        return (1 << L) | self.read_bits(L)

    def read_minimal_binary(self, z: int) -> int:
        s = max(1, (z - 1).bit_length()) if z > 1 else 0
        if z == 1:
            return 0
        t = (1 << s) - z
        m = self.read_bits(s - 1)
        if m < t:
            return m
        return ((m << 1) | self.read_bits(1)) - t

    def read_zeta(self, k: int = DEFAULT_K) -> int:
        h = self._zeros_run()
        lo = 1 << (h * k)
        z = (1 << ((h + 1) * k)) - lo
        return lo + self.read_minimal_binary(z)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode_graph(csr: CSR, k: int = DEFAULT_K) -> tuple[np.ndarray, np.ndarray]:
    """Encode a CSR graph. Returns (packed_bytes, bit_offsets[|V|+1]).

    Neighbor lists are sorted ascending (required by gap encoding).
    """
    n_v = csr.n_vertices
    degrees = csr.degrees()
    offsets = csr.offsets
    if n_v == 0:  # empty graph: no codes, a single zero bit offset
        return np.zeros(0, dtype=np.uint8), np.zeros(1, dtype=np.int64)

    # Sort each row ascending (vectorized: stable sort by (row, neighbor)).
    row = np.repeat(np.arange(n_v, dtype=np.int64), degrees)
    nbr = csr.neighbors.astype(np.int64, copy=False)
    order = np.lexsort((nbr, row))
    nbr = nbr[order]

    # Gap encoding requires strictly increasing successor lists (as in real
    # web graphs). Duplicate edges are not representable.
    same_row = row[1:] == row[:-1]
    if np.any(same_row & (nbr[1:] == nbr[:-1])):
        raise ValueError(
            "duplicate (src, dst) edge: WebGraph-style gap encoding requires "
            "strictly increasing successor lists; build the CSR with "
            "csr_from_edges(..., dedupe=True)")

    # Per-edge gap values (vectorized over all rows at once).
    is_first = np.zeros(len(nbr), dtype=bool)
    is_first[offsets[:-1][degrees > 0]] = True
    prev = np.empty_like(nbr)
    if len(nbr):  # edge-less graphs still carry their degree codes
        prev[1:] = nbr[:-1]
        prev[0] = 0
    first_nat = int2nat(nbr - row)            # first gap: zigzag(n0 - v)
    rest_gap = (nbr - prev - 1).astype(np.uint64)  # subsequent: n_i - n_{i-1} - 1
    nat = np.where(is_first, first_nat, rest_gap)

    # Build the interleaved code stream: gamma(d+1) then d zeta codes per row.
    n_codes = n_v + len(nbr)
    patterns = np.empty(n_codes, dtype=np.uint64)
    nbits = np.empty(n_codes, dtype=np.int64)
    # index of each vertex's degree code in the stream
    deg_idx = np.arange(n_v, dtype=np.int64) + offsets[:-1]
    pat_d, bits_d = gamma_code(degrees.astype(np.uint64) + 1)
    patterns[deg_idx] = pat_d
    nbits[deg_idx] = bits_d
    # index of each edge's code: edge e of row r lands at r + 1 + e_global
    edge_idx = row + 1 + np.arange(len(nbr), dtype=np.int64)
    pat_e, bits_e = zeta_code(nat + 1, k)
    patterns[edge_idx] = pat_e
    nbits[edge_idx] = bits_e

    packed, starts = pack_codes(patterns, nbits)
    bit_offsets = np.empty(n_v + 1, dtype=np.int64)
    bit_offsets[:-1] = starts[deg_idx]
    bit_offsets[-1] = starts[-1]
    return packed, bit_offsets


def write_webgraph(path_or_file: Union[str, os.PathLike, BinaryIO], csr: CSR,
                   k: int = DEFAULT_K) -> int:
    packed, bit_offsets = encode_graph(csr, k)
    header = _HEADER_STRUCT.pack(MAGIC, VERSION, k, 0, csr.n_vertices, csr.n_edges)
    own = False
    if isinstance(path_or_file, (str, os.PathLike)):
        f: BinaryIO = open(path_or_file, "wb")
        own = True
    else:
        f = path_or_file
    try:
        n = f.write(header)
        n += f.write(bit_offsets.astype("<u8").tobytes())
        n += f.write(packed.tobytes())
    finally:
        if own:
            f.close()
    return n


def webgraph_nbytes(csr: CSR, k: int = DEFAULT_K) -> int:
    packed, _ = encode_graph(csr, k)
    return HEADER_SIZE + 8 * (csr.n_vertices + 1) + packed.nbytes


# ---------------------------------------------------------------------------
# file reader with wavefront (vectorized) decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WebGraphHeader:
    k: int
    flags: int
    n_vertices: int
    n_edges: int

    @property
    def offsets_start(self) -> int:
        return HEADER_SIZE

    @property
    def data_start(self) -> int:
        return HEADER_SIZE + 8 * (self.n_vertices + 1)


def read_wg_header(f) -> WebGraphHeader:
    f.seek(0)
    raw = f.read(HEADER_SIZE)
    magic, version, k, flags, n_v, n_e = _HEADER_STRUCT.unpack(raw)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic!r}; not a WebGraph-style file")
    if version != VERSION:
        raise ValueError(f"unsupported version {version}")
    return WebGraphHeader(k=k, flags=flags, n_vertices=n_v, n_edges=n_e)


class _Wavefront:
    """Vectorized multi-cursor decoder: one code per round across vertices."""

    def __init__(self, bits: np.ndarray, k: int):
        self.bits = bits
        self.k = k
        self.ones = np.flatnonzero(bits).astype(np.int64)

    def _unary(self, pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Zero-run lengths at ``pos``; returns (run, next_pos_after_the_1)."""
        i = np.searchsorted(self.ones, pos)
        nxt = self.ones[i]
        return nxt - pos, nxt + 1

    def _read_fixed(self, pos: np.ndarray, width: int) -> np.ndarray:
        """Read ``width`` MSB-first bits at each ``pos`` (uniform width)."""
        if width == 0:
            return np.zeros(len(pos), dtype=np.uint64)
        idx = pos[:, None] + np.arange(width, dtype=np.int64)[None, :]
        gathered = self.bits[idx].astype(np.uint64)
        weights = np.uint64(1) << np.arange(width - 1, -1, -1, dtype=np.uint64)
        return gathered @ weights

    def gamma_many(self, pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        L, after = self._unary(pos)
        out = np.empty(len(pos), dtype=np.uint64)
        new_pos = after + L
        for Lv in np.unique(L):
            sel = L == Lv
            rest = self._read_fixed(after[sel], int(Lv))
            out[sel] = (np.uint64(1) << np.uint64(Lv)) | rest
        return out, new_pos

    def zeta_many(self, pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        k = self.k
        h, after = self._unary(pos)
        out = np.empty(len(pos), dtype=np.uint64)
        new_pos = np.empty(len(pos), dtype=np.int64)
        for hv in np.unique(h):
            sel = h == hv
            lo = np.uint64(1) << np.uint64(hv * k)
            z = int((np.uint64(1) << np.uint64((hv + 1) * k)) - lo)
            s = max(1, (z - 1).bit_length()) if z > 1 else 0
            if z == 1:
                out[sel] = lo
                new_pos[sel] = after[sel]
                continue
            t = (1 << s) - z
            p = after[sel]
            m = self._read_fixed(p, s - 1)
            long = m >= t
            extra = np.zeros(m.shape, dtype=np.uint64)
            if np.any(long):
                extra[long] = self.bits[p[long] + (s - 1)].astype(np.uint64)
            val = np.where(long, (m << np.uint64(1) | extra) - np.uint64(t), m)
            out[sel] = lo + val
            new_pos[sel] = p + (s - 1) + long.astype(np.int64)
        return out, new_pos


class WebGraphFile:
    """Reader over any seek/read file-like object (incl. PG-Fuse CachedFile)."""

    def __init__(self, file: Union[str, os.PathLike, BinaryIO]):
        if isinstance(file, (str, os.PathLike)):
            self._f: BinaryIO = open(file, "rb")
            self._own = True
        else:
            self._f = file
            self._own = False
        self.header = read_wg_header(self._f)
        self._bit_offsets: Optional[np.ndarray] = None

    @property
    def n_vertices(self) -> int:
        return self.header.n_vertices

    @property
    def n_edges(self) -> int:
        return self.header.n_edges

    def bit_offsets(self) -> np.ndarray:
        if self._bit_offsets is None:
            self._f.seek(self.header.offsets_start)
            raw = self._f.read(8 * (self.n_vertices + 1))
            self._bit_offsets = np.frombuffer(raw, dtype="<u8").astype(np.int64)
        return self._bit_offsets

    def _load_bits(self, bit0: int, bit1: int) -> tuple[np.ndarray, int]:
        """Unpacked bits covering [bit0, bit1); returns (bits, base_bit)."""
        byte0, byte1 = bit0 // 8, (bit1 + 7) // 8
        self._f.seek(self.header.data_start + byte0)
        raw = self._f.read(byte1 - byte0)
        bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8))
        return bits, byte0 * 8

    def decode_vertices(self, v0: int, v1: int) -> tuple[np.ndarray, np.ndarray]:
        """Wavefront-decode vertices [v0, v1) -> (local offsets, neighbors)."""
        offs = self.bit_offsets()
        bits, base = self._load_bits(int(offs[v0]), int(offs[v1]))
        wf = _Wavefront(bits, self.header.k)
        n = v1 - v0
        pos = offs[v0:v1] - base
        vid = np.arange(v0, v1, dtype=np.int64)

        dplus1, pos = wf.gamma_many(pos)
        degrees = (dplus1 - 1).astype(np.int64)
        out_offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(degrees, out=out_offsets[1:])
        neighbors = np.empty(int(out_offsets[-1]), dtype=np.int64)

        # Round r decodes the r-th neighbor for all rows with degree > r.
        active = np.flatnonzero(degrees > 0)
        prev = np.zeros(n, dtype=np.int64)
        r = 0
        while len(active):
            code, new_pos = wf.zeta_many(pos[active])
            nat = code.astype(np.int64) - 1
            if r == 0:
                val = vid[active] + nat2int(nat)
            else:
                val = prev[active] + nat + 1
            neighbors[out_offsets[active] + r] = val
            prev[active] = val
            pos[active] = new_pos
            r += 1
            active = active[degrees[active] > r]
        return out_offsets, neighbors

    def neighbors_of(self, v: int) -> np.ndarray:
        """Scalar random access via the sequential reference decoder."""
        offs = self.bit_offsets()
        bits, base = self._load_bits(int(offs[v]), int(offs[v + 1]))
        rd = BitReader(bits, int(offs[v]) - base)
        d = rd.read_gamma() - 1
        out = np.empty(d, dtype=np.int64)
        prev = 0
        for i in range(d):
            nat = rd.read_zeta(self.header.k) - 1
            prev = v + int(nat2int(np.array([nat]))[0]) if i == 0 else prev + nat + 1
            out[i] = prev
        return out

    def read_partition(self, v0: int, v1: int) -> tuple[np.ndarray, np.ndarray]:
        return self.decode_vertices(v0, v1)

    def read_full(self) -> CSR:
        offs, nbrs = self.decode_vertices(0, self.n_vertices)
        dtype = np.int32 if self.n_vertices <= np.iinfo(np.int32).max else np.int64
        return CSR(offsets=offs, neighbors=nbrs.astype(dtype))

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self) -> "WebGraphFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_webgraph(path: Union[str, os.PathLike, BinaryIO]) -> CSR:
    with WebGraphFile(path) as f:
        return f.read_full()


def roundtrip_bytes(csr: CSR, k: int = DEFAULT_K) -> bytes:
    buf = io.BytesIO()
    write_webgraph(buf, csr, k)
    return buf.getvalue()
