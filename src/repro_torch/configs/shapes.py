"""Input-shape sets, one per architecture family (40 cells), and the
input specs of each cell.

The ``*_input_specs`` builders give, for each cell, a dict of tensors on
the ``meta`` device (:func:`sds`): shape and dtype, no allocation -- the
port's counterpart of the JAX package's ``jax.ShapeDtypeStruct`` trees.
Shapes are the JAX package's on every cell, padding to ``NODE_PAD`` /
``EDGE_PAD`` included; dtypes too, except where the port widens ids:

  * LM ``tokens`` and ``labels`` are int64 (the JAX package's int32):
    the port's embedding lookup and loss take int64 ids;
  * DIN ``hist_*`` / ``cand_*`` ids are int64 (int32 there), as the
    port's DIN batches carry them.

LM ``long_500k`` is a recorded SKIP for all five LM archs: they are pure
full-attention (GQA) models and the shape needs sub-quadratic attention.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32

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


# ---------------------------------------------------------------------------
# input_specs builders (meta tensors only: never allocate)
# ---------------------------------------------------------------------------

def sds(shape, dtype=F32) -> torch.Tensor:
    """A shape-and-dtype stand-in: an empty tensor on the ``meta``
    device."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def lm_input_specs(shape: LMShape, cfg) -> dict:
    """``tokens`` (and ``labels`` to train) [B, S]; a decode step takes
    one token against a cache of ``seq_len`` positions: a tuple of
    per-layer ``[B, S, Hk, dh]`` buffers where ``cfg.unroll_layers``, one
    stacked ``[L, B, S, Hk, dh]`` buffer otherwise, and ``cache_len``."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": sds((B, S), I64), "labels": sds((B, S), I64)}
    if shape.kind == "prefill":
        return {"tokens": sds((B, S), I64)}
    if cfg.unroll_layers:
        layer = (B, S, cfg.n_kv_heads, cfg.d_head)
        return {
            "tokens": sds((B, 1), I64),
            "cache_k": tuple(sds(layer, cfg.dtype)
                             for _ in range(cfg.n_layers)),
            "cache_v": tuple(sds(layer, cfg.dtype)
                             for _ in range(cfg.n_layers)),
            "cache_len": sds((), I32),
        }
    cache_shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
    return {
        "tokens": sds((B, 1), I64),
        "cache_k": sds(cache_shape, cfg.dtype),
        "cache_v": sds(cache_shape, cfg.dtype),
        "cache_len": sds((), I32),
    }


def gnn_input_specs(shape: GNNShape, arch_id: str) -> dict:
    """Node arrays padded to ``NODE_PAD``, edge (and triplet) arrays to
    ``EDGE_PAD``; the per-model fields the loss reads."""
    N, E = _pad(shape.n_nodes, NODE_PAD), _pad(shape.n_edges, EDGE_PAD)
    specs = {
        "x": sds((N, shape.d_feat), F32),
        "edge_src": sds((E,), I32),
        "edge_dst": sds((E,), I32),
    }
    if arch_id == "dimenet":
        T = _pad(int(shape.triplet_factor * E), EDGE_PAD)
        specs.update({
            "pos": sds((N, 3), F32),
            "triplet_kj": sds((T,), I32),
            "triplet_ji": sds((T,), I32),
            "graph_id": sds((N,), I32),
            "targets": sds((shape.n_graphs, 1), F32),
        })
    elif arch_id == "meshgraphnet":
        specs.update({
            "edge_attr": sds((E, 8), F32),
            "targets": sds((N, 3), F32),
            "node_mask": sds((N,), torch.bool),
        })
    else:  # gcn / pna: node classification
        specs.update({
            "labels": sds((N,), I32),
            "label_mask": sds((N,), torch.bool),
        })
    return specs


def din_input_specs(shape: RecsysShape, cfg) -> dict:
    """A batch of ``B`` histories of ``cfg.seq_len`` items and one
    candidate each (labels to train); retrieval: one history against
    ``n_candidates`` padded to ``EDGE_PAD``."""
    S = cfg.seq_len
    if shape.kind == "retrieval":
        n_cand = _pad(shape.n_candidates, EDGE_PAD)
        return {
            "hist_items": sds((S,), I64), "hist_cates": sds((S,), I64),
            "cand_items": sds((n_cand,), I64),
            "cand_cates": sds((n_cand,), I64),
        }
    B = shape.batch
    specs = {
        "hist_items": sds((B, S), I64), "hist_cates": sds((B, S), I64),
        "cand_item": sds((B,), I64), "cand_cate": sds((B,), I64),
    }
    if shape.kind == "train":
        specs["labels"] = sds((B,), F32)
    return specs
