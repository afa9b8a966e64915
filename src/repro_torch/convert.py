"""Small bridges between numpy and the port's types.

The graph file is the state both packages share (same bytes on disk);
these functions put in-memory values on one footing too.  They take
numpy, so a test can hand them the JAX package's outputs without this
package importing it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.csr import CSR
from repro_torch.kernels.utils import resolve_device
from repro_torch.optim.adamw import tree_map


def csr_from_numpy(offsets, neighbors) -> CSR:
    """The port's :class:`CSR` from any array-likes (int64 offsets; the
    neighbors keep their integer dtype)."""
    return CSR(offsets=np.ascontiguousarray(offsets, dtype=np.int64),
               neighbors=np.ascontiguousarray(neighbors))


def shard_to_numpy(shard) -> tuple[int, int, np.ndarray, np.ndarray]:
    """``(v0, v1, offsets, neighbors)`` of a :class:`StreamedShard` on any
    device, as host numpy arrays."""
    return (int(shard.v0), int(shard.v1),
            shard.offsets.detach().cpu().numpy(),
            shard.neighbors.detach().cpu().numpy())


def stats_ints(stats) -> dict:
    """The integer counters of a ``StreamStats`` / ``QueryStats`` (or any
    stats dataclass) as a plain dict — durations, rates, strings and
    histograms are left out, dict-valued counters are copied."""
    out = {}
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        if isinstance(v, (bool, float)):
            continue
        if isinstance(v, (int, np.integer)):
            out[f.name] = int(v)
        elif isinstance(v, dict):
            out[f.name] = {k: int(n) for k, n in v.items()}
    return out


def gnn_params_from_numpy(params: dict, device=None) -> dict:
    """The JAX package's params of any of its GNNs -- a dict of numpy
    arrays, nested as the model keeps them (MeshGraphNet's ``node_enc``,
    DimeNet's ``block{i}``), e.g. ``jax.tree_util.tree_map(np.asarray,
    jax_params)`` -- as the port's params: the same keys and nesting,
    float32 tensors on ``device`` (None = the GPU, raises without
    one)."""
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)

    return conv(params)


def gcn_params_from_numpy(params: dict, device=None) -> dict:
    """The JAX package's GCN params (``{"w0": ..., "b0": ..., ...}`` as
    numpy arrays) as the port's: :func:`gnn_params_from_numpy`."""
    return gnn_params_from_numpy(params, device)


def din_params_from_numpy(params: dict, device=None) -> dict:
    """The JAX package's DIN params (``item_table``, ``cate_table`` and
    the ``attn`` / ``mlp`` dicts of dense layers, as numpy arrays) as the
    port's: :func:`gnn_params_from_numpy`."""
    return gnn_params_from_numpy(params, device)


def adamw_state_from_numpy(state: dict, device=None) -> dict:
    """The JAX package's AdamW state (``{"step", "m", "v"[, "master"]}``
    with the moments shaped and nested like the params, as numpy arrays,
    e.g. ``jax.tree_util.tree_map(np.asarray, opt)``) as the port's: ``step``
    an int32 0-d tensor, every other leaf a float32 tensor, on ``device``
    (None = the GPU, raises without one)."""
    device = resolve_device(device)

    out = {"step": torch.from_numpy(
        np.array(state["step"], dtype=np.int32)).to(device)}
    for key in ("m", "v", "master"):
        if key in state:
            out[key] = gnn_params_from_numpy(state[key], device)
    return out


def adamw_state_to_numpy(state: dict) -> dict:
    """The port's AdamW state as numpy arrays in the JAX package's
    structure (:func:`adamw_state_from_numpy`'s inverse), ready for
    ``jax.numpy.asarray``."""
    out = {"step": np.asarray(state["step"].detach().cpu().numpy(),
                              dtype=np.int32)}
    for key in ("m", "v", "master"):
        if key in state:
            out[key] = tree_map(lambda v: v.detach().cpu().numpy(),
                                state[key])
    return out


def transformer_params_from_numpy(params: dict, cfg, device=None) -> dict:
    """The JAX package's transformer params pytree as numpy (``embed``,
    ``final_norm_scale`` [, ``final_norm_bias``, ``lm_head``] and
    ``layers`` stacked over the L layers: ``wq, wk, wv, wo``, the norm
    scales [and biases, ``bq, bk, bv``], and either the dense FFN's
    ``w_gate, w_up, w_down`` or the MoE's ``router, we_gate, we_up,
    we_down`` [, ``ws_gate, ws_up, ws_down``, ``shared_gate``]; e.g.
    ``jax.tree_util.tree_map(np.asarray, jax_params)``) as the port's
    params dict: the same keys and shapes, tensors in ``cfg.dtype`` but
    the MoE router, float32 in both packages, on ``device`` (None = the
    GPU, raises without one)."""
    device = resolve_device(device)

    def t(a, dtype=cfg.dtype):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype)

    out = {k: t(v) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: t(v, torch.float32 if k == "router" else cfg.dtype)
                     for k, v in params["layers"].items()}
    return out
