"""Graph500 Kronecker edges drawn on the device from a seed.

The law is the Graph500 specification's generator (spec 3.0, the
reference ``kronecker_generator.m``): for each of ``scale`` levels two
uniforms per edge pick a quadrant of the initiator ``[[A, B], [C, D]]``
(``A, B, C = 0.57, 0.19, 0.19``), and a random permutation scrambles the
vertex labels.  The spec's final shuffle of the edge list is left out:
every consumer here sorts the edges into a CSR.

Everything is drawn with one ``torch.Generator`` on the target device in
a few large calls, so the same seed gives the same graph on the same
device type.  This module imports torch alone: it is the benchmark's
input, and nothing of the program under test touches it.
"""

from __future__ import annotations

import torch

A, B, C = 0.57, 0.19, 0.19


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any integer below
    2**64: the driver's seeds pass 32 bits)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))


def kronecker_ids(n_edges: int, scale: int, gen: torch.Generator,
                  device) -> tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) int64 ids in ``[0, 2**scale)`` of ``n_edges`` edges,
    unscrambled: the spec's quadrant walk, level by level."""
    ab = A + B
    c_norm = C / (1.0 - ab)
    a_norm = A / ab
    src = torch.zeros(n_edges, dtype=torch.int64, device=device)
    dst = torch.zeros(n_edges, dtype=torch.int64, device=device)
    for level in range(scale):
        ii = torch.rand(n_edges, generator=gen, device=device) > ab
        thresh = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(n_edges, generator=gen, device=device) > thresh
        src |= ii.to(torch.int64) << level
        dst |= jj.to(torch.int64) << level
    return src, dst


def graph500_csr(scale: int, edge_factor: int, seed: int, device, *,
                 structure_seed: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Graph500 graph of ``2**scale`` vertices and ``edge_factor *
    2**scale`` generated directed edges as a CSR on ``device``: labels
    scrambled, duplicate (src, dst) pairs dropped, each row's neighbours
    ascending, self loops kept (the port's ``rmat`` convention).

    The quadrant walk is drawn from ``structure_seed`` (``seed`` when
    None) and the label permutation from ``seed``: with a fixed
    ``structure_seed`` every seed gives an isomorphic graph, the same
    degrees and sizes under other labels.

    Returns ``(offsets int64[|V|+1], neighbors int32[|E|])``.
    """
    n = 1 << scale
    gen = generator(seed if structure_seed is None else structure_seed,
                    device)
    src, dst = kronecker_ids(edge_factor * n, scale, gen, device)
    if structure_seed is not None:
        gen = generator(seed, device)
    perm = torch.randperm(n, generator=gen, device=device)
    key = (perm[src] << scale) | perm[dst]
    del src, dst, perm
    key = torch.unique(key)                  # sorted, duplicates dropped
    rows = key >> scale
    neighbors = (key & (n - 1)).to(torch.int32)
    del key
    counts = torch.bincount(rows, minlength=n)
    del rows
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return offsets, neighbors


def bounded_edges(n_nodes: int, n_edges: int, scale: int, seed: int,
                  device) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_edges`` Kronecker edges over ``n_nodes <= 2**scale`` vertices:
    every edge with an end at or above ``n_nodes`` is drawn again (both
    ends, so the joint law holds on the kept square), then the ids are
    scrambled by a permutation of ``[0, n_nodes)``.  Duplicates are kept,
    as the generator emits them.  Returns int64 (src, dst) on
    ``device``.
    """
    if not 0 < n_nodes <= 1 << scale:
        raise ValueError(f"{n_nodes} nodes do not fit scale {scale}")
    gen = generator(seed, device)
    src, dst = kronecker_ids(n_edges, scale, gen, device)
    bad = torch.nonzero((src >= n_nodes) | (dst >= n_nodes)).flatten()
    while bad.numel():
        s, d = kronecker_ids(bad.numel(), scale, gen, device)
        src[bad], dst[bad] = s, d
        keep = (s >= n_nodes) | (d >= n_nodes)
        bad = bad[keep]
    perm = torch.randperm(n_nodes, generator=gen, device=device)
    return perm[src], perm[dst]
