"""CSR/CSC graph container (paper §II).

A graph G=(V,E) in Compressed Sparse Row/Column form: an ``offsets`` array of
|V|+1 elements and a ``neighbors`` array of |E| elements.  ``offsets[v]`` is
the index of the first neighbor of ``v`` in ``neighbors``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSR:
    """In-memory CSR graph. ``offsets`` is int64[|V|+1], ``neighbors`` holds
    vertex IDs (int32 when |V| < 2^31, else int64)."""

    offsets: np.ndarray
    neighbors: np.ndarray

    def __post_init__(self) -> None:
        self.offsets = np.ascontiguousarray(self.offsets, dtype=np.int64)
        if self.offsets.ndim != 1 or self.offsets.shape[0] < 1:
            raise ValueError("offsets must be a 1-D array of |V|+1 elements")
        if int(self.offsets[0]) != 0:
            raise ValueError("offsets[0] must be 0")
        if self.neighbors.ndim != 1:
            raise ValueError("neighbors must be 1-D")
        if int(self.offsets[-1]) != self.neighbors.shape[0]:
            raise ValueError(
                f"offsets[-1]={int(self.offsets[-1])} != |E|={self.neighbors.shape[0]}"
            )

    @property
    def n_vertices(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.neighbors.shape[0]

    def degree(self, v: int) -> int:
        return int(self.offsets[v + 1] - self.offsets[v])

    def degrees(self) -> np.ndarray:
        return np.diff(self.offsets)

    def neighbors_of(self, v: int) -> np.ndarray:
        return self.neighbors[int(self.offsets[v]) : int(self.offsets[v + 1])]

    def edge_index(self) -> np.ndarray:
        """Return (2, |E|) [src; dst] COO edge index (row-major expansion)."""
        src = np.repeat(np.arange(self.n_vertices, dtype=self.neighbors.dtype), self.degrees())
        return np.stack([src, self.neighbors.astype(src.dtype)])

    def __eq__(self, other: object) -> bool:  # pragma: no cover - convenience
        if not isinstance(other, CSR):
            return NotImplemented
        return bool(
            np.array_equal(self.offsets, other.offsets)
            and np.array_equal(self.neighbors, other.neighbors)
        )


def csr_from_edges(src: np.ndarray, dst: np.ndarray, n_vertices: int, *,
                   sort_neighbors: bool = True, dedupe: bool = False) -> CSR:
    """Build CSR from a COO edge list.

    ``dedupe=True`` drops duplicate (src, dst) pairs — required before
    WebGraph-style encoding, which assumes strictly increasing successor
    lists (real web graphs carry no duplicate links)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError("src/dst shape mismatch")
    if sort_neighbors:
        order = np.lexsort((dst, src))  # group rows, neighbors ascending in-row
    else:
        order = np.argsort(src, kind="stable")
    src, dst_s = src[order], dst[order]
    if dedupe:
        keep = np.ones(len(src), dtype=bool)
        keep[1:] = (src[1:] != src[:-1]) | (dst_s[1:] != dst_s[:-1])
        src, dst_s = src[keep], dst_s[keep]
    counts = np.bincount(src, minlength=n_vertices)
    offsets = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    dtype = np.int32 if n_vertices <= np.iinfo(np.int32).max else np.int64
    return CSR(offsets=offsets, neighbors=dst_s.astype(dtype))
