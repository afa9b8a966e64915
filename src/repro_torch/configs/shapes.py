"""Input-shape sets, one per architecture family (the JAX package's
catalog of cells, shape tables only).

The JAX package's ``*_input_specs`` functions make ``jax.ShapeDtypeStruct``
trees for its dry run; they wait for the port of that layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Ragged graph sizes are padded up to these multiples in the JAX
# package's sharded cells; padded edge slots carry id -1 and are dropped
# by the segment ops, padded nodes receive zero features and no edges.
NODE_PAD = 256
EDGE_PAD = 512


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # "train" | "prefill" | "decode"
    skip_reason: Optional[str] = None


LM_SHAPES = {
    "train_4k": LMShape("train_4k", 4096, 256, "train"),
    "prefill_32k": LMShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": LMShape("decode_32k", 32768, 128, "decode"),
    "long_500k": LMShape(
        "long_500k", 524288, 1, "decode",
        skip_reason=("needs sub-quadratic attention; all five assigned LM "
                     "archs are pure full-attention (GQA) models — skip per "
                     "assignment rules, recorded in DESIGN.md §5")),
}


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int
    n_graphs: int = 1            # >1: batched small graphs (graph targets)
    triplet_factor: float = 4.0  # DimeNet triplet budget = factor * n_edges
    kind: str = "train"


GNN_SHAPES = {
    # Cora: full-batch semi-supervised node classification
    "full_graph_sm": GNNShape("full_graph_sm", 2708, 10556, 1433, 7),
    # Reddit-scale sampled training: padded 2-hop tree from the neighbor
    # sampler (batch_nodes=1024, fanout 15-10); d_feat=602 (Reddit).
    "minibatch_lg": GNNShape(
        "minibatch_lg",
        n_nodes=1024 + 1024 * 15 + 1024 * 150,
        n_edges=1024 * 15 + 1024 * 150,
        d_feat=602, n_classes=41),
    # ogbn-products full-batch
    "ogb_products": GNNShape("ogb_products", 2_449_029, 61_859_140, 100, 47),
    # batched small molecules: 128 graphs x 30 nodes / 64 edges.
    "molecule": GNNShape("molecule", 128 * 30, 128 * 64, 16, 16, n_graphs=128),
}

# source-graph metadata for the minibatch_lg sampler (Reddit)
MINIBATCH_SOURCE = {"n_nodes": 232_965, "n_edges": 114_615_892,
                    "batch_nodes": 1024, "fanout": (15, 10)}


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    name: str
    batch: int
    kind: str                   # "train" | "serve" | "retrieval"
    n_candidates: int = 0


RECSYS_SHAPES = {
    "train_batch": RecsysShape("train_batch", 65_536, "train"),
    "serve_p99": RecsysShape("serve_p99", 512, "serve"),
    "serve_bulk": RecsysShape("serve_bulk", 262_144, "serve"),
    "retrieval_cand": RecsysShape("retrieval_cand", 1, "retrieval",
                                  n_candidates=1_000_000),
}
