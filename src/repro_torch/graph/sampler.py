"""Layer-wise fanout neighbor sampling (GraphSAGE regime) — the host-side
producer for the ``minibatch_lg`` shape.

The sampler reads adjacency through the ParaGrapher API (or an in-memory
CSR), so on a pod each host samples its own seed range while the graph
lives in CompBin on shared storage behind PG-Fuse — the paper's loading
path *is* the sampler's hot loop.

Preferred adjacency source: a
:class:`repro_torch.query.NeighborQueryEngine` (anything exposing
``neighbors_batch``) — each layer's whole frontier is fetched as ONE
deduplicated, block-coalesced batch instead of one storage round-trip
per slot, which is where CompBin's byte-addressable random access
(paper §IV) actually pays.  The sampled output is bit-identical to the
per-vertex path for the same seed: only the fetch is batched, the RNG
consumption order is unchanged.

Output is a **padded tree layout** with static shapes (the same shape
for every request of one fanout, as the JAX package needs for jit):
layer l holds ``n_seeds * prod(fanouts[:l])`` node slots; slot ``i`` of
layer l+1 region ``[i*f : (i+1)*f]`` holds the sampled neighbors of layer-l
slot ``i``.  Missing neighbors (degree < fanout) are marked invalid and
dropped by the aggregation (their edge ids are -1, see
``launch/data_gnn.py::block_to_edges``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np

from repro_torch.core.csr import CSR
from repro_torch.core.paragrapher import GraphHandle


@dataclasses.dataclass
class SampledBlock:
    """One minibatch of layered samples (all arrays static-shaped)."""

    seeds: np.ndarray                 # int64[n_seeds]
    layer_nodes: list[np.ndarray]     # [n_seeds * prod(fanouts[:l])] per layer
    layer_valid: list[np.ndarray]     # bool, same shapes
    fanouts: tuple[int, ...]

    @property
    def frontier(self) -> np.ndarray:
        return self.layer_nodes[-1]

    def num_nodes(self) -> int:
        return sum(len(x) for x in self.layer_nodes)


class NeighborSampler:
    """Uniform fanout sampler over a CSR, an open ParaGrapher handle, or
    a batched query engine (``neighbors_batch`` duck type)."""

    def __init__(self, graph: Union[CSR, GraphHandle], fanouts: Sequence[int],
                 *, seed: int = 0):
        self._g = graph
        self._batched = hasattr(graph, "neighbors_batch")
        self.fanouts = tuple(int(f) for f in fanouts)
        self._rng = np.random.default_rng(seed)

    def _neighbors(self, v: int) -> np.ndarray:
        if isinstance(self._g, CSR):
            return self._g.neighbors_of(v)
        return self._g.neighbors_of(v)

    def _layer_adjacency(self, nodes: np.ndarray, valid: np.ndarray) -> dict:
        """Adjacency for one layer's frontier, keyed by vertex id.

        With a query engine the whole frontier goes out as one
        deduplicated coalesced batch (vertices shared between slots — the
        hub-heavy common case — are fetched once); otherwise each unique
        vertex is read individually.
        """
        if self._batched:
            # the engine dedups internally — handing it the raw frontier
            # (repeated hubs and all) keeps its dedup-ratio stats honest.
            # The per-slot lists come back as views into the decoded
            # spans, so this is already copy-free; the engine's ragged
            # form exists for consumers that want ONE flat buffer.
            live = nodes[valid]
            lists = self._g.neighbors_batch(live)
            return {int(v): np.asarray(nbrs) for v, nbrs in zip(live, lists)}
        uniq = np.unique(nodes[valid]) if valid.any() else np.zeros(0, np.int64)
        lists = [self._neighbors(int(v)) for v in uniq]
        return {int(v): np.asarray(nbrs) for v, nbrs in zip(uniq, lists)}

    @property
    def n_vertices(self) -> int:
        return self._g.n_vertices

    def sample(self, seeds: np.ndarray) -> SampledBlock:
        seeds = np.asarray(seeds, dtype=np.int64)
        layer_nodes = [seeds]
        layer_valid = [np.ones(len(seeds), dtype=bool)]
        for f in self.fanouts:
            prev = layer_nodes[-1]
            prev_valid = layer_valid[-1]
            adj = self._layer_adjacency(prev, prev_valid)
            nxt = np.full(len(prev) * f, -1, dtype=np.int64)
            val = np.zeros(len(prev) * f, dtype=bool)
            for i, (v, ok) in enumerate(zip(prev, prev_valid)):
                if not ok:
                    continue
                nbrs = adj[int(v)]
                d = len(nbrs)
                if d == 0:
                    continue
                if d >= f:
                    pick = self._rng.choice(nbrs, size=f, replace=False)
                    nxt[i * f : (i + 1) * f] = pick
                    val[i * f : (i + 1) * f] = True
                else:
                    nxt[i * f : i * f + d] = nbrs
                    val[i * f : i * f + d] = True
            layer_nodes.append(nxt)
            layer_valid.append(val)
        return SampledBlock(seeds=seeds, layer_nodes=layer_nodes,
                            layer_valid=layer_valid, fanouts=self.fanouts)

    def sample_batches(self, batch_nodes: int, n_batches: int):
        """Yield blocks over random seed batches (training epochs)."""
        n = self.n_vertices
        for _ in range(n_batches):
            seeds = self._rng.integers(0, n, batch_nodes)
            yield self.sample(seeds)
