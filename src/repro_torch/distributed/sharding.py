"""Per-family sharding rules (partition-spec trees) over a mesh, and the
device placement of streamed CSR shards (data/graph_stream.py).

Spec builders -- the JAX package's rules, unchanged.  Mesh axes:
``("data", "model")`` single-pod, ``("pod", "data", "model")`` multi-pod
(:mod:`repro_torch.launch.mesh`; only axis sizes are read).  Batch always
shards over ``("pod", "data")``; weights shard over ``"model"`` in
Megatron-style tensor parallelism where divisibility allows:

  * attention heads shard over model iff ``n_heads % model == 0``;
    otherwise the attention weights stay replicated;
  * MoE experts shard over model on the expert axis;
  * embedding / lm_head shard the vocab over model;
  * ZeRO-1: optimizer moments / master shard over "data" along each
    param's largest model-unsharded divisible axis (:func:`zero_opt_specs`).

A spec is a :class:`P`: a tuple whose entries are ``None``, an axis name
or a tuple of axis names, equal as a tuple to JAX's ``PartitionSpec``.
:func:`named` turns a spec tree into DTensor placements, plain data built
without a process group.  JAX's ``shard_map`` has no counterpart: the
port's collectives take explicit process groups
(``optim/compression.py``).

Streamed CSR shards: the port drives one GPU per process, so
:func:`host_submesh` and :func:`stream_shard_placement` reduce to "the one
device" and return a :class:`torch.device`; the names and arguments are
kept so the loader reads the same in both packages.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.utils import resolve_device
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


def host_submesh(device: "torch.device | str | None" = None,
                 process_index: int = 0,
                 process_count: int = 1) -> torch.device:
    """The device process ``process_index`` of ``process_count`` drives.

    Every process of a multi-host load owns its own card and passes it as
    ``device`` (``None`` = the current CUDA device; raises without one).
    """
    if not 0 <= process_index < max(1, process_count):
        raise ValueError(
            f"process_index {process_index} not in [0, {process_count})")
    return resolve_device(device)


def stream_shard_placement(device: "torch.device | str | None",
                           n_edges: int, *, process_index: int = 0,
                           process_count: int = 1
                           ) -> tuple[torch.device, torch.device]:
    """(neighbors, offsets) placement for one streamed CSR partition:
    both live whole on the calling process's device."""
    dev = host_submesh(device, process_index, process_count)
    return dev, dev


# ---------------------------------------------------------------------------
# partition specs
# ---------------------------------------------------------------------------

def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name
    or a tuple of axis names, major first); trailing dims unnamed are
    replicated.  As in JAX, a one-name tuple is that name and an empty
    one None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _is_spec_leaf(x: Any) -> bool:
    return x is None or isinstance(x, P)


def spec_leaves(tree: Any) -> list:
    """Leaves of a spec tree (:class:`P` or None), dict keys in sorted
    order, as ``jax.tree`` and the port's ``tree_leaves`` take them."""
    if _is_spec_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in spec_leaves(t)]
    return [tree]


def spec_map(fn, tree: Any) -> Any:
    """``fn`` over the leaves of a spec tree, keeping its structure."""
    if _is_spec_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: spec_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(spec_map(fn, v) for v in tree)
    return fn(tree)


def axis_size(mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def batch_axes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if axes else None


def spec_axes(entry) -> tuple:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(i)`` where tensor dim ``i`` names that axis, else
    ``Replicate()``.  A tensor dim sharded over several axes splits them
    major first, as JAX does; DTensor splits the mesh dims sharding one
    tensor dim in mesh order, so the axes of an entry must come in mesh
    order (raises otherwise).  ``None`` is replicated."""
    from torch.distributed.tensor.placement_types import Replicate, Shard

    out = [Replicate() for _ in mesh.axis_names]
    for dim, entry in enumerate(spec or ()):
        axes = spec_axes(entry)
        order = [mesh.axis_names.index(a) for a in axes
                 if a in mesh.axis_names]
        if len(order) != len(axes):
            raise ValueError(f"spec {spec!r} names an axis not in "
                             f"{mesh.axis_names}")
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} does not follow the "
                             f"mesh order {mesh.axis_names}")
        for j in order:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"axis {mesh.axis_names[j]!r} used twice "
                                 f"in {spec!r}")
            out[j] = Shard(dim)
    return tuple(out)


def named(mesh, spec_tree: Any) -> Any:
    """The DTensor placements of every spec in ``spec_tree``
    (:func:`placements`), in its structure."""
    return spec_map(lambda s: placements(mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def lm_param_specs(cfg, mesh) -> dict:
    """Param specs of a ``TransformerConfig``: 4-D projections (L, d, H,
    dh) shard the head axis where it divides the model axis (arguments
    must shard evenly; odd head counts keep the attention weights
    replicated)."""
    m = axis_size(mesh, "model")
    q_ok = cfg.n_heads % m == 0
    kv_ok = cfg.n_kv_heads % m == 0
    attn_col_q = P(None, None, "model", None) if q_ok else P(None, None, None, None)
    attn_col_kv = P(None, None, "model", None) if kv_ok else P(None, None, None, None)
    attn_row = P(None, "model", None, None) if q_ok else P(None, None, None, None)
    attn_bias_q = P(None, "model", None) if q_ok else P(None, None, None)
    attn_bias_kv = P(None, "model", None) if kv_ok else P(None, None, None)

    layers: dict = {
        "attn_norm_scale": P(None, None),
        "ffn_norm_scale": P(None, None),
        "wq": attn_col_q, "wk": attn_col_kv, "wv": attn_col_kv,
        "wo": attn_row,
    }
    if cfg.norm == "layernorm":
        layers["attn_norm_bias"] = P(None, None)
        layers["ffn_norm_bias"] = P(None, None)
    if cfg.qkv_bias:
        layers["bq"] = attn_bias_q
        layers["bk"] = attn_bias_kv
        layers["bv"] = attn_bias_kv
    if cfg.moe:
        layers["router"] = P(None, None, None)
        layers["we_gate"] = P(None, "model", None, None)   # expert parallel
        layers["we_up"] = P(None, "model", None, None)
        layers["we_down"] = P(None, "model", None, None)
        if cfg.n_shared_experts:
            layers["ws_gate"] = P(None, None, "model")
            layers["ws_up"] = P(None, None, "model")
            layers["ws_down"] = P(None, "model", None)
            if cfg.shared_expert_gate:
                layers["shared_gate"] = P(None, None, None)
    else:
        layers["w_gate"] = P(None, None, "model")
        layers["w_up"] = P(None, None, "model")
        layers["w_down"] = P(None, "model", None)

    specs: dict = {
        "embed": P("model", None),
        "final_norm_scale": P(None),
        "layers": layers,
    }
    if cfg.norm == "layernorm":
        specs["final_norm_bias"] = P(None)
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, "model")
    return specs


def lm_batch_spec(mesh) -> P:
    return P(batch_axes(mesh), None)


def lm_cache_specs(cfg, mesh, batch: int) -> dict:
    """KV cache: a tuple of per-layer [B, Smax, Hkv, dh] buffers
    (``cfg.unroll_layers``) or one stacked [L, B, Smax, Hkv, dh]."""
    b_axes = batch_axes(mesh)
    total_b = 1
    for a in (b_axes or ()):
        total_b *= axis_size(mesh, a)
    b_ax = b_axes if (b_axes and batch % total_b == 0) else None
    kv_ax = "model" if cfg.n_kv_heads % axis_size(mesh, "model") == 0 else None
    if cfg.unroll_layers:
        layer = P(b_ax, None, kv_ax, None)
        kv = tuple(layer for _ in range(cfg.n_layers))
    else:
        kv = P(None, b_ax, None, kv_ax, None)
    return {"k": kv, "v": kv, "len": P()}


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def gnn_specs(mesh, batch_like: dict) -> dict:
    """Edge arrays shard over every axis (flattened); node/feature arrays
    shard rows over ("data", "model"); small per-graph arrays replicate."""
    all_axes = tuple(mesh.axis_names)
    node_axes = tuple(a for a in ("data", "model") if a in mesh.axis_names)

    def spec_for(key: str, arr) -> P:
        if key.startswith("edge_") or key.startswith("triplet_"):
            return P(all_axes) if arr.ndim == 1 else P(all_axes, None)
        if key in ("x", "pos"):
            return P(node_axes, None)
        if key in ("labels", "label_mask", "graph_id", "node_mask"):
            return P(node_axes)
        if key == "targets":
            return P(None, None) if arr.ndim == 2 else P(None)
        return P(*([None] * arr.ndim))

    return {k: spec_for(k, v) for k, v in batch_like.items()
            if hasattr(v, "ndim")}


# ---------------------------------------------------------------------------
# Recsys (DIN)
# ---------------------------------------------------------------------------

def din_param_specs(mesh) -> dict:
    return {
        "item_table": P("model", None),   # 10M rows row-sharded
        "cate_table": P("model", None),
        "attn": None,                     # small MLPs replicated
        "mlp": None,
    }


def din_specs(params_like: dict, mesh) -> dict:
    def replicated(x):
        return P(*([None] * x.ndim))

    return {
        "item_table": P("model", None),
        "cate_table": P("model", None),
        "attn": tree_map(replicated, params_like["attn"]),
        "mlp": tree_map(replicated, params_like["mlp"]),
    }


def din_batch_specs(mesh, batch_like: dict) -> dict:
    b_axes = batch_axes(mesh)
    all_axes = tuple(mesh.axis_names)

    def spec_for(key: str, arr) -> P:
        if key.startswith("cand_") and arr.ndim == 1 and arr.shape[0] >= 1024:
            # retrieval: candidate axis shards over everything
            return P(all_axes)
        if key.startswith("hist_") and arr.ndim == 1:
            # retrieval: one user's history, replicated
            return P(None)
        return P(b_axes, *([None] * (arr.ndim - 1)))

    return {k: spec_for(k, v) for k, v in batch_like.items()
            if hasattr(v, "ndim")}


# ---------------------------------------------------------------------------
# ZeRO-1 optimizer-state sharding
# ---------------------------------------------------------------------------

def zero_spec(shape: tuple, spec: P, mesh) -> P:
    """Add "data" sharding on the largest axis not already sharded."""
    d = axis_size(mesh, "data")
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = None, 0
    for i, (s, n) in enumerate(zip(entries, shape)):
        if s is None and n % d == 0 and n > best_size:
            best, best_size = i, n
    if best is not None:
        entries[best] = "data"
    return P(*entries)


def zero_opt_specs(params_like: Any, param_specs: Any, mesh) -> dict:
    """Optimizer-state spec tree for ``optim.adamw``'s state
    (step/m/v/master)."""
    flat_p = tree_leaves(params_like)
    flat_s = spec_leaves(param_specs)
    assert len(flat_p) == len(flat_s), (len(flat_p), len(flat_s))
    mv = tree_unflatten(params_like, [zero_spec(tuple(p.shape), s, mesh)
                                      for p, s in zip(flat_p, flat_s)])
    return {"step": P(), "m": mv, "v": mv, "master": mv}
