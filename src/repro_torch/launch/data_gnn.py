"""Convert sampled blocks / generated graphs into model batch dicts.

The serving side of the JAX package's module: assets, the block's edge
index, the store-gathered batch and its one-pass transfer to the device.
The training-side functions (``streamed_graph_batch``,
``shards_to_edge_index``, ``full_graph_batch``, ...) wait for the
training slice.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.graph.sampler import SampledBlock
from repro_torch.kernels.utils import resolve_device


def ensure_gnn_assets(workdir: str, d_in: int, n_classes: int, *,
                      scale: int = 10, edge_factor: int = 8, seed: int = 1,
                      block_size: int = 1 << 16
                      ) -> tuple[str, str, str]:
    """Idempotently materialize the demo GNN storage triplet in
    ``workdir``: CompBin topology + feature store + label/mask column
    family (all block-aligned to ``block_size``).  Returns
    (graph_path, feature_path, label_path) — the same files, byte for
    byte, as the JAX package writes for the same arguments.
    """
    from repro_torch.core import paragrapher
    from repro_torch.graph import (featstore_for_graph, labelstore_for_graph,
                                   rmat, synthesize_node_features,
                                   synthesize_separable_labels)

    os.makedirs(workdir, exist_ok=True)
    gp = os.path.join(workdir, f"graph_s{scale}e{edge_factor}.cbin")
    if not os.path.exists(gp):
        paragrapher.save_graph(gp, rmat(scale, edge_factor, seed=seed),
                               format="compbin")
    fp = os.path.join(workdir, f"graph_s{scale}e{edge_factor}_d{d_in}.fst")
    if not os.path.exists(fp):
        featstore_for_graph(gp, fp, d_in, seed=0, data_align=block_size)
    lp = os.path.join(workdir,
                      f"graph_s{scale}e{edge_factor}_d{d_in}c{n_classes}.lbl")
    if not os.path.exists(lp):
        # labels derived from the stored features (fixed projection), so
        # training on the triplet has signal to fit — loss decreases
        with paragrapher.open_graph(gp) as g:
            n = g.n_vertices
        x = synthesize_node_features(n, d_in, seed=0)
        labelstore_for_graph(gp, lp, n_classes, seed=0,
                             labels=synthesize_separable_labels(x, n_classes),
                             data_align=block_size)
    return gp, fp, lp


def block_to_edges(block: SampledBlock) -> tuple[np.ndarray, np.ndarray, int]:
    """Padded tree block -> (edge_src, edge_dst) local indices + n_nodes.

    Layer l slot i's children occupy slots [i*f, (i+1)*f) of layer l+1;
    edges point child -> parent (message flows to the seed side).
    """
    offsets = np.cumsum([0] + [len(x) for x in block.layer_nodes])
    srcs, dsts = [], []
    for l, f in enumerate(block.fanouts):
        n_par = len(block.layer_nodes[l])
        child_base = offsets[l + 1]
        par_base = offsets[l]
        child_idx = child_base + np.arange(n_par * f)
        par_idx = par_base + np.repeat(np.arange(n_par), f)
        valid = block.layer_valid[l + 1]
        srcs.append(np.where(valid, child_idx, -1))
        dsts.append(np.where(valid, par_idx, -1))
    return (np.concatenate(srcs), np.concatenate(dsts), int(offsets[-1]))


def device_batch(np_batch: dict, device=None) -> dict:
    """Ship a whole numpy batch dict to ``device`` in one pass: one
    ``torch.from_numpy(...).to(device)`` per tensor, nothing else
    (``device=None`` means the GPU and raises without one)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(v).to(device) for k, v in np_batch.items()}


def sampled_host_batch(arch_id: str, cfg, block: SampledBlock, feats,
                       labels=None) -> dict:
    """The host (numpy) half of :func:`sampled_store_batch`: the block's
    edge index and its feature rows (and label/mask rows) gathered from
    the stores, before anything crosses to the device."""
    from repro_torch.query.engine import gather_rows

    src, dst, n = block_to_edges(block)
    nodes = np.concatenate(block.layer_nodes)
    valid = np.concatenate(block.layer_valid)
    x = gather_rows(feats, np.where(valid, nodes, -1))
    batch = {
        "x": np.ascontiguousarray(x, dtype=np.float32),
        "edge_src": src.astype(np.int32),
        "edge_dst": dst.astype(np.int32),
    }
    if arch_id in ("gcn-cora", "pna"):
        n_seeds = len(block.seeds)
        lab = np.full(n, -1, np.int64)
        mask = np.zeros(n, bool)
        if labels is not None:
            fam = gather_rows(labels, block.seeds)
            lab[:n_seeds] = fam[:, 0].astype(np.int64)
            # only seeds the store marks as training rows contribute loss
            mask[:n_seeds] = fam[:, 1].astype(bool)
        batch["labels"] = lab
        batch["label_mask"] = mask
    return batch


def sampled_store_batch(arch_id: str, cfg, block: SampledBlock, feats,
                        labels=None, *, device=None) -> dict:
    """Minibatch dict from a sampled block with REAL per-node tensors:
    feature rows gathered from the feature store and (when a label store
    is given) seed labels/masks from the label column family.

    ``feats``/``labels`` are
    :class:`repro_torch.core.featstore.FeatureStoreHandle` objects,
    typically mounted on the SAME PG-Fuse instance as the graph the block
    was sampled from.  Row gathers go through
    :func:`repro_torch.query.engine.gather_rows` (dedup + run-coalesced
    reads), and the assembled batch crosses to ``device`` in one pass
    (:func:`device_batch`).
    """
    return device_batch(sampled_host_batch(arch_id, cfg, block, feats,
                                           labels), device)
