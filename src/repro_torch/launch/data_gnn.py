"""Convert sampled blocks / generated graphs / streamed shards into
model batch dicts of tensors.

Serving: assets, the block's edge index, the store-gathered batch and
its one-pass transfer to the device.  Training: the sampled block with
stand-in features (:func:`block_to_batch`), the full-graph batch built
on the device from streamed shards (:func:`streamed_graph_batch`), and
the one from an in-memory CSR (:func:`full_graph_batch`).  Only the
last and :func:`block_to_batch` build the fields MeshGraphNet and
DimeNet read (:data:`MODEL_FIELDS`), as in the JAX package; the other
paths refuse those models (:func:`refuse_unbuilt_fields`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core.csr import CSR
from repro_torch.graph.sampler import SampledBlock
from repro_torch.kernels.utils import resolve_device


#: the batch fields beyond ``x`` / ``edge_src`` / ``edge_dst`` that a
#: model's forward and loss read and that only :func:`block_to_batch` and
#: :func:`full_graph_batch` build (:func:`model_fields`)
MODEL_FIELDS = {
    "meshgraphnet": ("edge_attr", "targets"),
    "dimenet": ("pos", "triplet_kj", "triplet_ji", "graph_id", "n_graphs",
                "targets"),
}


def model_fields(arch_id: str, cfg, n: int, n_edges: int, rng) -> dict:
    """:data:`MODEL_FIELDS` of ``arch_id`` as numpy, drawn from ``rng`` in
    the JAX package's order: MeshGraphNet's random edge features and
    node targets; DimeNet's positions, 2E random triplets of edge ids,
    one graph and its target.  Empty for the other models."""
    if arch_id == "meshgraphnet":
        return {"edge_attr": rng.standard_normal(
                    (n_edges, cfg.d_edge_in)).astype(np.float32),
                "targets": rng.standard_normal((n, cfg.d_out)).astype(
                    np.float32)}
    if arch_id == "dimenet":
        pos = rng.standard_normal((n, 3)).astype(np.float32)
        return {"pos": pos,
                "triplet_kj": rng.integers(0, n_edges, 2 * n_edges).astype(
                    np.int32),
                "triplet_ji": rng.integers(0, n_edges, 2 * n_edges).astype(
                    np.int32),
                "graph_id": np.zeros(n, np.int32),
                "targets": rng.standard_normal((1, 1)).astype(np.float32),
                "n_graphs": 1}
    return {}


def refuse_unbuilt_fields(arch_id: str, path: str) -> None:
    """Exit at once, naming the fields, where ``path`` (serving,
    ``--full-graph``, ``--sampled``) builds none of the batch fields
    ``arch_id`` needs.  The JAX package runs on into a ``KeyError`` deep
    inside ``forward`` there."""
    fields = MODEL_FIELDS.get(arch_id)
    if fields:
        raise SystemExit(
            f"{arch_id}: {path} builds no {', '.join(fields)} batch fields; "
            f"{arch_id} trains in the default minibatch mode only")


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


def block_features(block: SampledBlock, d_feat: int, rng) -> np.ndarray:
    """Feature matrix for all block nodes (hashed-random stand-in: real
    deployments gather rows from the feature store through PG-Fuse)."""
    nodes = np.concatenate(block.layer_nodes)
    feats = rng.standard_normal((len(nodes), d_feat)).astype(np.float32)
    return np.where((nodes >= 0)[:, None], feats, 0)


def block_to_batch(arch_id: str, cfg, block: SampledBlock, rng, *,
                   device=None) -> dict:
    """Training batch from a sampled block with stand-in features and
    labels drawn from ``rng`` as the JAX package draws them, on
    ``device`` (None = the GPU, raises without one)."""
    src, dst, n = block_to_edges(block)
    d_in = getattr(cfg, "d_in", getattr(cfg, "d_node_in", 16))
    x = block_features(block, d_in, rng)
    batch = {
        "x": x,
        "edge_src": src.astype(np.int32),
        "edge_dst": dst.astype(np.int32),
    }
    n_seeds = len(block.seeds)
    if arch_id in ("gcn-cora", "pna"):
        n_classes = cfg.n_classes
        labels = np.full(n, -1, np.int64)
        labels[:n_seeds] = rng.integers(0, n_classes, n_seeds)
        mask = np.zeros(n, bool)
        mask[:n_seeds] = True
        batch["labels"] = labels
        batch["label_mask"] = mask
    else:
        batch.update(model_fields(arch_id, cfg, n, len(src), rng))
        if arch_id == "meshgraphnet":
            batch["node_mask"] = np.arange(n) < n_seeds
    return device_batch(batch, device)


def device_batch(np_batch: dict, device=None) -> dict:
    """Ship a whole numpy batch dict to ``device`` in one pass: one
    ``torch.from_numpy(...).to(device)`` per array, nothing else; a
    Python value (DimeNet's ``n_graphs``) passes through unchanged
    (``device=None`` means the GPU and raises without one)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
            else v for k, v in np_batch.items()}


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


def shards_to_edge_index(shards) -> tuple:
    """Streamed device shards -> (edge_src, edge_dst) int32 ON the shards'
    device.

    The whole point of the streaming loader: the neighbor IDs never exist
    decoded on the host, so the edge index is derived where it is
    consumed.  Row IDs are expanded from each shard's offsets with the
    shard's edge count as the output size, so nothing waits on the
    device."""
    srcs, dsts = [], []
    for s in sorted(shards, key=lambda sh: sh.v0):
        dev = s.neighbors.device
        deg = torch.diff(s.offsets.to(dev))
        srcs.append(torch.repeat_interleave(
            torch.arange(s.v0, s.v1, dtype=torch.int32, device=dev), deg,
            output_size=s.n_edges))
        dsts.append(s.neighbors.to(torch.int32))
    if not srcs:
        z = torch.zeros(0, dtype=torch.int32)
        return z, z
    return torch.cat(srcs), torch.cat(dsts)


def shards_to_features(shards) -> "torch.Tensor | None":
    """Streamed per-shard feature rows -> one (n, d) device matrix.

    Returns None when the shards carry no features (no store attached).
    A MIX of featured and feature-less shards is an error: it means some
    host streamed the feature store and some did not, and training would
    silently run on garbage rows for the missing range.
    """
    shards = sorted(shards, key=lambda s: s.v0)
    have = [s.x is not None for s in shards]
    if not any(have):
        return None
    if not all(have):
        missing = [(s.v0, s.v1) for s, h in zip(shards, have) if not h]
        raise ValueError(
            f"shards {missing} carry no feature rows but others do; every "
            f"host must stream the same feature store")
    return torch.cat([s.x for s in shards])


def shards_to_labels(shards) -> "tuple | None":
    """Streamed label-family rows -> (labels int32[n], mask bool[n]) on
    device, or None when no label store was attached.  Mixed
    labeled/unlabeled shards are an error for the same reason mixed
    feature shards are (see :func:`shards_to_features`)."""
    shards = sorted(shards, key=lambda s: s.v0)
    have = [s.y is not None for s in shards]
    if not any(have):
        return None
    if not all(have):
        missing = [(s.v0, s.v1) for s, h in zip(shards, have) if not h]
        raise ValueError(
            f"shards {missing} carry no label rows but others do; every "
            f"host must stream the same label store")
    y = torch.cat([s.y for s in shards])
    return y[:, 0].to(torch.int32), y[:, 1].to(torch.bool)


def streamed_graph_batch(arch_id: str, cfg, shards, rng, *,
                         n_classes: int = 7,
                         n_vertices: int | None = None) -> dict:
    """Full-graph training dict straight from streamed device shards
    (the device-resident sibling of :func:`full_graph_batch`), on the
    shards' device.

    ``shards`` may come from one stream or from every host of a
    multi-host load (``data/multihost.py::all_shards``); full-graph
    training needs the WHOLE vertex range, so a gap in coverage (a host's
    shards missing) is an error, not a silently smaller graph.  Pass
    ``n_vertices`` (the graph's true vertex count, e.g.
    ``HostResult.n_vertices``) to also reject a missing TAIL — without it
    only interior gaps are detectable.

    When the stream carried a feature store (``feature_path=``), ``x``
    is the shards' real feature rows — storage -> PG-Fuse -> device with
    zero host synthesis; the random stand-in is drawn from ``rng`` only
    for feature-less streams.  When it also carried the label/mask column
    family (``label_path=``), ``labels``/``label_mask`` come off storage
    too and the batch holds ZERO synthetic tensors.
    """
    shards = sorted(shards, key=lambda s: s.v0)
    expect = 0
    for s in shards:
        if s.v0 != expect:
            raise ValueError(
                f"streamed shards do not cover the graph: gap/overlap at "
                f"vertex {expect} (next shard starts at {s.v0}); full-graph "
                f"training needs every host's shards")
        expect = s.v1
    if n_vertices is not None and expect != n_vertices:
        raise ValueError(
            f"streamed shards cover only [0, {expect}) of {n_vertices} "
            f"vertices (trailing host missing); full-graph training needs "
            f"every host's shards")
    src, dst = shards_to_edge_index(shards)
    dev = src.device
    n = expect  # the coverage loop proved the shards tile [0, expect)
    d_in = getattr(cfg, "d_in", getattr(cfg, "d_node_in", 16))
    x = shards_to_features(shards)
    if x is not None and int(x.shape[1]) != d_in:
        raise ValueError(
            f"feature store rows have d={int(x.shape[1])} but the model "
            f"expects d_in={d_in}")
    if x is None:
        x = torch.from_numpy(
            rng.standard_normal((n, d_in)).astype(np.float32)).to(dev)
    batch = {
        "x": x.to(torch.float32),
        "edge_src": src,
        "edge_dst": dst,
    }
    if arch_id in ("gcn-cora", "pna"):
        lab = shards_to_labels(shards)
        if lab is not None:
            top = int(lab[0].max()) if lab[0].numel() else -1
            if top >= n_classes:
                raise ValueError(
                    f"label store holds class {top} but the model expects "
                    f"n_classes={n_classes}")
            batch["labels"], batch["label_mask"] = lab
        else:
            batch["labels"] = torch.from_numpy(
                rng.integers(0, n_classes, n)).to(dev)
            batch["label_mask"] = torch.from_numpy(rng.random(n) < 0.3).to(dev)
    return batch


def full_graph_batch(arch_id: str, cfg, csr: CSR, rng, *,
                     n_classes: int = 7, device=None) -> dict:
    """Full-batch training dict from an in-memory CSR, on ``device``
    (None = the GPU, raises without one)."""
    src, dst = csr.edge_index()
    n = csr.n_vertices
    d_in = getattr(cfg, "d_in", getattr(cfg, "d_node_in", 16))
    batch = {
        "x": rng.standard_normal((n, d_in)).astype(np.float32),
        "edge_src": src.astype(np.int32),
        "edge_dst": dst.astype(np.int32),
    }
    if arch_id in ("gcn-cora", "pna"):
        batch["labels"] = rng.integers(0, n_classes, n)
        batch["label_mask"] = rng.random(n) < 0.3
    else:
        batch.update(model_fields(arch_id, cfg, n, len(src), rng))
    return device_batch(batch, device)
