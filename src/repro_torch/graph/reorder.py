"""The offline graph compiler: locality reordering + recompression.

The ROADMAP's recompression stage, and the consumer of the codec
registry (:mod:`repro_torch.core.codec`).  The pipeline is

1. **order** — compute a locality-improving vertex permutation
   (:func:`bfs_order` from a max-degree root, :func:`degree_order`, or
   identity), selected by :func:`repro_torch.core.policy.choose_reorder`;
2. **permute** — remap the CSR through the permutation
   (:func:`permute_csr`): ids renamed, rows re-sorted, so each
   neighborhood's vertices land on nearby ids — a batch's packed-byte
   reads then touch fewer PG-Fuse blocks, and the PG-Fuse/hot-set hit
   rates rise on the same logical trace;
3. **encode** — re-serialize through ANY registered codec (CompBin or
   the bit-packed LogCSR), plus a **sidecar** holding the inverse
   permutation so query answers map back to original ids byte-
   identically (:func:`map_back`).

A compiled graph is queried in its NEW id space: translate request ids
with ``new_of_old``, answer, then :func:`map_back` the neighbor lists
with the sidecar's ``old_of_new`` — for sorted adjacency lists the
result equals the original graph's answer exactly.

Sidecar layout (little-endian): 16-byte header (magic b"GPRM",
version u16, 2 pad, n_vertices u64) followed by ``old_of_new`` as
``|V|`` u64 words.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Optional, Union

import numpy as np

from repro_torch.core import codec as _codec
from repro_torch.core import policy as _policy
from repro_torch.core.csr import CSR, csr_from_edges

SIDECAR_MAGIC = b"GPRM"
SIDECAR_VERSION = 1
_SIDECAR_STRUCT = struct.Struct("<4sHxxQ")
SIDECAR_HEADER_SIZE = 16
assert _SIDECAR_STRUCT.size == SIDECAR_HEADER_SIZE


# ---------------------------------------------------------------------------
# orderings
# ---------------------------------------------------------------------------


def bfs_order(csr: CSR) -> np.ndarray:
    """BFS level-order permutation ``new_of_old`` from a max-degree root.

    Vertices are numbered in visit order: level by level, ascending old
    id within a level (deterministic).  Each further component restarts
    at its max-degree unvisited vertex, so disconnected hubs still lead
    their component's block.  Neighborhoods end up numerically clustered
    — the locality the paper leaves on the table when vertex order is
    "whatever the input had".
    """
    n = csr.n_vertices
    new_of_old = np.full(n, -1, dtype=np.int64)
    if n == 0:
        return new_of_old
    degrees = csr.degrees()
    # visit components by descending root degree (ties: ascending id)
    root_rank = np.lexsort((np.arange(n), -degrees))
    visited = np.zeros(n, dtype=bool)
    next_id = 0
    for root in root_rank:
        if visited[root]:
            continue
        visited[root] = True
        frontier = np.array([root], dtype=np.int64)
        while frontier.size:
            new_of_old[frontier] = np.arange(
                next_id, next_id + frontier.size)
            next_id += frontier.size
            # all neighbors of the level in one gather, then the unseen
            # ones (sorted unique = ascending ids within the next level)
            spans = [csr.neighbors[csr.offsets[v]:csr.offsets[v + 1]]
                     for v in frontier]
            nxt = np.unique(np.concatenate(spans)) if spans else \
                np.zeros(0, np.int64)
            nxt = nxt[~visited[nxt]]
            visited[nxt] = True
            frontier = nxt.astype(np.int64)
    assert next_id == n
    return new_of_old


def degree_order(csr: CSR) -> np.ndarray:
    """Hubs-first permutation ``new_of_old``: descending degree,
    ascending old id on ties — the cheap frequency clustering (the hot
    set lands in the first blocks)."""
    n = csr.n_vertices
    order = np.lexsort((np.arange(n), -csr.degrees()))  # old ids by rank
    new_of_old = np.empty(n, dtype=np.int64)
    new_of_old[order] = np.arange(n)
    return new_of_old


def identity_order(csr: CSR) -> np.ndarray:
    return np.arange(csr.n_vertices, dtype=np.int64)


ORDER_FNS = {
    "bfs": bfs_order,
    "degree": degree_order,
    "identity": identity_order,
}


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    """``inv[perm[i]] = i`` — turns ``new_of_old`` into ``old_of_new``
    and vice versa.  Validates that ``perm`` IS a permutation."""
    perm = np.asarray(perm, dtype=np.int64)
    n = perm.size
    inv = np.full(n, -1, dtype=np.int64)
    if n and (perm.min() < 0 or perm.max() >= n):
        raise ValueError("not a permutation: ids out of range")
    inv[perm] = np.arange(n)
    if (inv < 0).any():
        raise ValueError("not a permutation: duplicate ids")
    return inv


def permute_csr(csr: CSR, new_of_old: np.ndarray) -> CSR:
    """Rename every vertex through ``new_of_old`` and rebuild the CSR
    (rows re-sorted ascending in the new id space)."""
    new_of_old = np.asarray(new_of_old, dtype=np.int64)
    if new_of_old.size != csr.n_vertices:
        raise ValueError(f"permutation has {new_of_old.size} entries "
                         f"for |V|={csr.n_vertices}")
    invert_permutation(new_of_old)  # validation only
    src, dst = csr.edge_index()
    return csr_from_edges(new_of_old[np.asarray(src, dtype=np.int64)],
                          new_of_old[np.asarray(dst, dtype=np.int64)],
                          csr.n_vertices)


def map_back(old_of_new: np.ndarray, new_ids: np.ndarray) -> np.ndarray:
    """Translate a neighbor run answered in compiled-id space back to
    ORIGINAL ids, re-sorted ascending — byte-identical to the original
    graph's (sorted) adjacency list."""
    old = np.asarray(old_of_new, dtype=np.int64)[
        np.asarray(new_ids, dtype=np.int64)]
    return np.sort(old)


# ---------------------------------------------------------------------------
# the sidecar (inverse permutation persisted next to the compiled graph)
# ---------------------------------------------------------------------------


def sidecar_path_for(graph_path: Union[str, os.PathLike]) -> str:
    return os.fspath(graph_path) + ".perm"


def write_sidecar(path: Union[str, os.PathLike],
                  old_of_new: np.ndarray) -> int:
    """Persist ``old_of_new`` (compiled id -> original id)."""
    old_of_new = np.asarray(old_of_new, dtype=np.int64)
    invert_permutation(old_of_new)  # refuse to persist a non-permutation
    header = _SIDECAR_STRUCT.pack(SIDECAR_MAGIC, SIDECAR_VERSION,
                                  old_of_new.size)
    body = old_of_new.astype("<u8").tobytes()
    with open(path, "wb") as f:
        n = f.write(header)
        n += f.write(body)
    return n


def read_sidecar(path: Union[str, os.PathLike]) -> np.ndarray:
    """Load ``old_of_new`` back (int64), validating the header."""
    with open(path, "rb") as f:
        raw = f.read(SIDECAR_HEADER_SIZE)
        if len(raw) != SIDECAR_HEADER_SIZE:
            raise ValueError("truncated permutation sidecar header")
        magic, version, n = _SIDECAR_STRUCT.unpack(raw)
        if magic != SIDECAR_MAGIC:
            raise ValueError(f"bad magic {magic!r}; not a permutation "
                             f"sidecar")
        if version != SIDECAR_VERSION:
            raise ValueError(f"unsupported sidecar version {version}")
        body = f.read(8 * n)
    if len(body) != 8 * n:
        raise IOError(f"corrupt/truncated sidecar: promises {n} entries, "
                      f"holds {len(body) // 8}")
    old_of_new = np.frombuffer(body, dtype="<u8").astype(np.int64)
    invert_permutation(old_of_new)
    return old_of_new


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompileReport:
    """What one :func:`compile_graph` run did (the CLI prints this)."""

    in_path: str
    out_path: str
    sidecar_path: str
    codec: str
    strategy: str
    reason: str
    n_vertices: int
    n_edges: int
    in_bytes: int
    out_bytes: int
    verified_vertices: int

    @property
    def compression_ratio(self) -> float:
        """Input bytes per output byte (> 1: the compile shrank it)."""
        return self.in_bytes / self.out_bytes if self.out_bytes else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["compression_ratio"] = self.compression_ratio
        return d


def compile_graph(in_path: Union[str, os.PathLike],
                  out_path: Union[str, os.PathLike], *,
                  codec: str = "compbin",
                  strategy: Optional[str] = None,
                  sidecar: Optional[Union[str, os.PathLike]] = None,
                  verify_samples: int = 64,
                  seed: int = 0) -> CompileReport:
    """Reorder + re-encode one on-disk graph (the offline compile).

    Reads ``in_path`` (any registered codec), applies the permutation
    :func:`repro_torch.core.policy.choose_reorder` picks (or the explicit
    ``strategy``), writes the compiled graph to ``out_path`` with codec
    ``codec`` and the inverse permutation to ``sidecar`` (default:
    ``out_path + ".perm"``).  Before returning it samples
    ``verify_samples`` vertices and asserts the compiled graph's
    answers, mapped back through the sidecar, equal the original's —
    the compile is refused (files removed) if they ever differ.
    """
    from repro_torch.core import paragrapher

    spec = _codec.get_codec(codec)
    in_path = os.fspath(in_path)
    out_path = os.fspath(out_path)
    sidecar = os.fspath(sidecar) if sidecar is not None \
        else sidecar_path_for(out_path)

    with paragrapher.open_graph(in_path) as g:
        original = g.read_full()
    plan = _policy.choose_reorder(original.n_vertices, original.n_edges,
                                  strategy=strategy)
    new_of_old = ORDER_FNS[plan.strategy](original)
    old_of_new = invert_permutation(new_of_old)
    compiled = permute_csr(original, new_of_old)

    out_bytes = spec.write(out_path, compiled)
    write_sidecar(sidecar, old_of_new)

    # sample verification: compiled answers must map back byte-identically
    rng = np.random.default_rng(seed)
    n_check = min(verify_samples, original.n_vertices)
    sample = rng.choice(original.n_vertices, size=n_check, replace=False) \
        if n_check else np.zeros(0, np.int64)
    rdr = spec.open(out_path)
    try:
        for v in sample:
            v = int(v)
            got = map_back(old_of_new,
                           np.asarray(rdr.neighbors_of(new_of_old[v])))
            want = np.sort(np.asarray(
                original.neighbors[original.offsets[v]:
                                   original.offsets[v + 1]],
                dtype=np.int64))
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"compiled graph diverged at vertex {v}: inverse-"
                    f"mapped answer != original adjacency list")
    except BaseException:
        rdr.close()
        for p in (out_path, sidecar):  # never leave a bad compile behind
            if os.path.exists(p):
                os.remove(p)
        raise
    rdr.close()

    return CompileReport(
        in_path=in_path, out_path=out_path, sidecar_path=sidecar,
        codec=codec, strategy=plan.strategy, reason=plan.reason,
        n_vertices=original.n_vertices, n_edges=original.n_edges,
        in_bytes=os.path.getsize(in_path), out_bytes=out_bytes,
        verified_vertices=int(n_check))
