"""Node-feature converters: build ``core.featstore`` files for a graph.

Real pipelines convert whatever raw feature source they have (npy dumps,
parquet columns, an embedding table) into the fixed-stride FeatStore
layout once, then stream it through PG-Fuse on every epoch.  This module
provides that converter plus a deterministic synthesizer for graphs that
ship without features (RMAT/ER benchmark graphs): the synthesized matrix
is a pure function of ``(n_vertices, d, seed)``, so tests can regenerate
any row range independently and byte-compare it against store reads.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np

from repro_torch.core import featstore


def synthesize_node_features(n_vertices: int, d: int, *, seed: int = 0,
                             dtype=np.float32) -> np.ndarray:
    """Deterministic stand-in feature matrix (n_vertices, d)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_vertices, d)).astype(dtype)


def write_node_features(path: Union[str, os.PathLike], x: np.ndarray, *,
                        dtype=None,
                        data_align: int = featstore.DEFAULT_DATA_ALIGN
                        ) -> int:
    """Convert a feature matrix into a FeatStore file; returns bytes
    written.  Pass ``data_align=pgfuse_block_size`` so block-aligned
    plan cuts (``partition.split_plan(align=...)``) make per-host
    feature reads block-disjoint."""
    return featstore.write_featstore(path, x, dtype=dtype,
                                     data_align=data_align)


#: column layout of the label family: row v = [class id, train-mask flag]
LABEL_FAMILY_D = 2


def synthesize_node_labels(n_vertices: int, n_classes: int, *, seed: int = 0,
                           train_fraction: float = 0.3) -> np.ndarray:
    """Deterministic (n_vertices, 2) uint8 label family:
    column 0 = class id, column 1 = 1 where the vertex is in the training
    mask.  Like :func:`synthesize_node_features` it is a pure function of
    its arguments, so tests regenerate any row range and byte-compare."""
    if not 0 < n_classes <= 256:
        raise ValueError(f"n_classes must be in (0, 256] for the u8 "
                         f"label family, got {n_classes}")
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n_vertices).astype(np.uint8)
    mask = (rng.random(n_vertices) < train_fraction).astype(np.uint8)
    return np.stack([y, mask], axis=1)


def synthesize_separable_labels(x: np.ndarray, n_classes: int, *,
                                seed: int = 0) -> np.ndarray:
    """Labels a model can actually learn from ``x``: argmax of a fixed
    random linear projection of the feature rows.  Deterministic in
    ``(x, n_classes, seed)``, so a training run on the synthesized
    stores has a decreasing loss to assert on — uniformly random labels
    would leave nothing to fit."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((x.shape[1], n_classes))
    return np.argmax(np.asarray(x, dtype=np.float64) @ w, axis=1).astype(
        np.uint8)


def labelstore_for_graph(graph_path: Union[str, os.PathLike],
                         out_path: Union[str, os.PathLike], n_classes: int,
                         *, seed: int = 0,
                         data_align: int = featstore.DEFAULT_DATA_ALIGN,
                         labels: Optional[np.ndarray] = None,
                         mask: Optional[np.ndarray] = None) -> str:
    """Write the label/mask column family matching ``graph_path``.

    Labels and masks are a SECOND fixed-stride column family beside the
    feature store — same FeatStore wire format, same PG-Fuse mount at
    stream time — so full-graph batches carry zero synthetic tensors
    (``x`` from the feature family, ``labels``/``label_mask`` from this
    one).  ``labels``/``mask`` supply real data; without them the
    deterministic synthesizer stands in.  Returns ``out_path``.
    """
    from repro_torch.core import paragrapher

    with paragrapher.open_graph(graph_path) as g:
        n = g.n_vertices
    if labels is None:
        fam = synthesize_node_labels(n, n_classes, seed=seed)
        if mask is not None:
            fam[:, 1] = np.asarray(mask).astype(np.uint8)
    else:
        labels = np.asarray(labels)
        if labels.shape[0] != n:
            raise ValueError(f"label rows {labels.shape[0]} != "
                             f"graph vertices {n}")
        if labels.max(initial=0) >= n_classes:
            raise ValueError(f"label {int(labels.max())} out of range for "
                             f"{n_classes} classes")
        m = (np.ones(n, np.uint8) if mask is None
             else np.asarray(mask).astype(np.uint8))
        fam = np.stack([labels.astype(np.uint8), m], axis=1)
    featstore.write_featstore(out_path, fam, data_align=data_align)
    return os.fspath(out_path)


def featstore_for_graph(graph_path: Union[str, os.PathLike],
                        out_path: Union[str, os.PathLike], d: int, *,
                        seed: int = 0, dtype=None,
                        data_align: int = featstore.DEFAULT_DATA_ALIGN,
                        x: Optional[np.ndarray] = None) -> str:
    """Write the feature store matching ``graph_path``'s vertex count.

    ``x`` supplies real features (row count must equal |V|) and is
    stored in ITS dtype unless ``dtype`` explicitly overrides — a
    caller's float16 matrix must not silently widen to float32 and
    double the store's byte stream.  Without ``x`` a synthesized matrix
    stands in (float32 unless ``dtype`` says otherwise).  Returns
    ``out_path``.
    """
    from repro_torch.core import paragrapher

    with paragrapher.open_graph(graph_path) as g:
        n = g.n_vertices
    if x is None:
        x = synthesize_node_features(n, d, seed=seed,
                                     dtype=dtype or np.float32)
    elif x.shape[0] != n:
        raise ValueError(
            f"feature rows {x.shape[0]} != graph vertices {n}")
    write_node_features(out_path, x, dtype=dtype, data_align=data_align)
    return os.fspath(out_path)
