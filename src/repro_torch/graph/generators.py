"""Synthetic graph generators (paper §I: synthetic generators are one of the
three pillars of algorithm evaluation; the paper's g500 dataset is a
Graph500 RMAT graph).

RMAT [Chakrabarti et al., SDM'04] with Graph500 parameters
(a,b,c,d) = (0.57, 0.19, 0.19, 0.05) produces the skewed, power-law-ish
degree distributions of web/social graphs — the regime where WebGraph
compression shines and CompBin pays storage for decode speed.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.csr import CSR, csr_from_edges


def rmat(scale: int, edge_factor: int = 16, *,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         seed: int = 0, dedupe: bool = True) -> CSR:
    """RMAT graph with 2^scale vertices and ~edge_factor * 2^scale edges."""
    n = 1 << scale
    n_edges = edge_factor * n
    rng = np.random.default_rng(seed)
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    ab = a + b
    abc = a + b + c
    for level in range(scale):
        r = rng.random(n_edges)
        go_right = (r >= a) & (r < ab) | (r >= abc)   # quadrant b or d
        go_down = r >= ab                             # quadrant c or d
        src |= (go_down.astype(np.int64) << level)
        dst |= (go_right.astype(np.int64) << level)
    return csr_from_edges(src, dst, n, dedupe=dedupe)


def erdos_renyi(n_vertices: int, n_edges: int, *, seed: int = 0,
                dedupe: bool = True) -> CSR:
    """Uniform random directed graph (low-skew contrast to RMAT)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges)
    dst = rng.integers(0, n_vertices, n_edges)
    return csr_from_edges(src, dst, n_vertices, dedupe=dedupe)


def bipartite_mesh(nx: int, ny: int) -> CSR:
    """Regular 2-D mesh (MeshGraphNet-style simulation meshes): node (i,j)
    connects to its 4-neighborhood, both directions."""
    n = nx * ny
    idx = np.arange(n).reshape(nx, ny)
    srcs, dsts = [], []
    for (sa, sb) in [((slice(None, -1), slice(None)), (slice(1, None), slice(None))),
                     ((slice(None), slice(None, -1)), (slice(None), slice(1, None)))]:
        u = idx[sa].reshape(-1)
        v = idx[sb].reshape(-1)
        srcs += [u, v]
        dsts += [v, u]
    return csr_from_edges(np.concatenate(srcs), np.concatenate(dsts), n, dedupe=True)
