"""Cell builder: (arch x shape x mesh) -> step function + placements +
input specs + model FLOPs.

The single source of truth the dry run (``launch/dryrun.py``),
``chip_smoke.py``'s ``[cells]`` phase and any benchmark read, as the JAX
package's ``launch/steps.py`` is for its own.  A :class:`Cell` holds:

  * ``fn``: the eager step on real tensors -- the training steps take
    their gradients by autograd and update with the port's
    ``adamw_update``; prefill, decode, serve and retrieval run under
    ``torch.inference_mode()``;
  * ``args``: the step's arguments as trees of ``meta`` tensors (shape
    and dtype only, :func:`repro_torch.configs.shapes.sds`);
  * ``in_shardings`` / ``out_shardings``: DTensor placements trees on
    the cell's mesh (:func:`repro_torch.distributed.sharding.named`);
  * ``model_flops`` from :mod:`repro_torch.launch.model_flops`.

:func:`_abstract` is the counterpart of ``jax.eval_shape``: it runs a
function under ``FakeTensorMode`` on fake CPU tensors, where every kernel
wrapper takes its plain version and nothing is computed.  It never
traces on fake CUDA tensors: the wrappers would hand a fake pointer to
the kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_arch
from repro_torch.configs.shapes import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
                                        GNNShape, din_input_specs,
                                        gnn_input_specs, lm_input_specs, sds)
from repro_torch.distributed import sharding as shard_rules
from repro_torch.distributed.sharding import P
from repro_torch.launch import model_flops as mf
from repro_torch.models import transformer as tf
from repro_torch.models.gnn import dimenet as m_dimenet
from repro_torch.models.gnn import gcn as m_gcn
from repro_torch.models.gnn import meshgraphnet as m_mgn
from repro_torch.models.gnn import pna as m_pna
from repro_torch.models.recsys import din as m_din
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     tree_leaves, tree_map, tree_unflatten)


@dataclasses.dataclass
class Cell:
    """One (arch, shape) cell on a mesh.  ``donate`` names the arguments
    the JAX package donates to its jitted step; it is kept for the
    reader and has no effect in eager mode (the step returns new state
    tensors; the caller drops the old ones).  ``compute_dtype`` picks
    the roofline's compute peak; ``cfg`` is the model config the step
    closes over.  A prefill or decode cell's ``fn`` also takes
    ``attend=``, the serving attention it calls (default the port's
    :func:`~repro_torch.models.transformer.attention`)."""
    arch_id: str
    shape_id: str
    kind: str                      # train | prefill | decode | serve | retrieval
    fn: Optional[Callable]         # fn(*args)
    args: Optional[tuple]          # meta-tensor trees
    in_shardings: Optional[tuple]
    out_shardings: Any
    model_flops: float
    skip_reason: Optional[str] = None
    donate: tuple = ()
    compute_dtype: torch.dtype = torch.float32
    cfg: Any = None


def _named(mesh, tree: Any) -> Any:
    return shard_rules.named(mesh, tree)


def _replicated_specs(tree_like: Any) -> Any:
    return tree_map(lambda x: P(*([None] * x.ndim)), tree_like)


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return isinstance(t, torch.Tensor) and is_fake(t)


def _to_fake(tree: Any) -> Any:
    """Each tensor of ``tree`` as a fresh fake CPU tensor of its shape
    and dtype (call inside the fake mode); other leaves as they are."""
    def one(x):
        if not isinstance(x, torch.Tensor):
            return x
        return torch.empty(tuple(x.shape), dtype=x.dtype, device="cpu")
    return tree_map(one, tree)


def to_meta(tree: Any) -> Any:
    """Each tensor of ``tree`` as a ``meta`` tensor of its shape and
    dtype."""
    return tree_map(lambda x: sds(x.shape, x.dtype)
                    if isinstance(x, torch.Tensor) else x, tree)


def _attention_footprint(q, k, v, cfg, *, causal: bool, q_offset: int = 0):
    """What a serving attention call holds on the card: the
    flash-attention kernel's output, nothing more (no [S, S] scores)."""
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def _abstract(fn: Callable, *args, mode=None, **kwargs) -> Any:
    """``fn(*args, **kwargs)`` under ``FakeTensorMode`` on fake CPU
    tensors of the args' shapes and dtypes: the outputs as fake trees,
    nothing computed or allocated (the counterpart of
    ``jax.eval_shape``).  ``mode``, a further ``TorchDispatchMode`` (a
    :class:`~repro_torch.launch.hlo_analysis.CostMode`), sees every op of
    ``fn`` and none of the argument set-up.  Every kernel wrapper takes
    its plain version; a serving LM cell's ``fn`` given
    ``attend=_attention_footprint`` holds only what the flash-attention
    kernel holds on the card, for a memory estimate of the card's path
    (the training attention is plain on the card too)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = _to_fake(args)
        if mode is None:
            return fn(*fake, **kwargs)
        if hasattr(mode, "external"):
            mode.external(fake)
        with mode:
            return fn(*fake, **kwargs)


class _NoValues(TorchDispatchMode):
    """A dispatch mode for the abstract parameter init: a draw's values
    are never needed for its shape, and torch's truncated-normal
    rejection sampler asks whether any draw fell outside its bounds --
    the trace answers no (0) to every such read of a value."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            return 0
        return func(*args, **(kwargs or {}))


def _abstract_init(init: Callable) -> Any:
    """``init(generator)``'s parameter tree as ``meta`` tensors, drawn
    under fake tensors (:class:`_NoValues`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(), _NoValues():
        params = init(torch.Generator().manual_seed(0))
        return to_meta(params)


def _train_step(loss: Callable, opt_cfg: AdamWConfig) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradients by autograd, then :func:`adamw_update`."""
    def train_step(state, batch):
        params = state["params"]
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            l = loss(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(l, leaves)
        new_params, opt, met = adamw_update(params, list(grads),
                                            state["opt"], opt_cfg)
        return ({"params": new_params, "opt": opt},
                {**met, "loss": l.detach()})
    return train_step


def _opt_shape(params_shape: Any, opt_cfg: AdamWConfig) -> Any:
    return to_meta(_abstract(lambda p: adamw_init(p, opt_cfg), params_shape))


_MET_SPECS = {"grad_norm": P(), "lr": P(), "loss": P()}


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _cache_len(t: torch.Tensor, seq_len: int) -> int:
    """The decode position a cell's ``cache_len`` holds: read from a
    real tensor; a fake one has no value, and the trace writes the token
    at the cache's last slot (``seq_len - 1``), the full-KV step the
    cell's model FLOPs count."""
    return seq_len - 1 if _is_fake(t) else int(t)


def _lm_cell(arch_id: str, shape_id: str, mesh, *,
             opt_cfg: Optional[AdamWConfig] = None,
             cfg_overrides: Optional[dict] = None,
             unroll: bool = True) -> Cell:
    spec = get_arch(arch_id)
    shape = LM_SHAPES[shape_id]
    cfg = spec.make_config()
    # the JAX package's defaults: per-layer (unrolled) caches, and the
    # plain chunked attention's chunk per shape
    defaults: dict = {"unroll_layers": unroll, "attn_unroll": unroll}
    if shape.kind == "train":
        defaults["attn_chunk"] = 2048
    elif shape.kind == "prefill":
        defaults["attn_chunk"] = 8192
    m_size = shard_rules.axis_size(mesh, "model")
    defaults["attn_head_axis"] = "model"
    defaults["batch_axes"] = tuple(shard_rules.batch_axes(mesh))
    if cfg.n_kv_heads % m_size != 0:
        defaults["attn_kv_expand"] = True
    overrides = {**defaults, **(cfg_overrides or {})}
    if cfg.moe and "moe_ep_axis" not in overrides:
        overrides["moe_ep_axis"] = "model"
    cfg = dataclasses.replace(cfg, **overrides)
    if shape.skip_reason:
        return Cell(arch_id, shape_id, shape.kind, None, None, None, None,
                    0.0, skip_reason=shape.skip_reason, cfg=cfg)

    flops = mf.lm_model_flops(cfg, shape)
    params_shape = _abstract_init(lambda g: tf.init_params(cfg, g))
    p_specs = shard_rules.lm_param_specs(cfg, mesh)
    batch_spec = shard_rules.lm_batch_spec(mesh)
    inputs = lm_input_specs(shape, cfg)
    common = dict(compute_dtype=cfg.dtype, cfg=cfg)

    if shape.kind == "train":
        opt_cfg = opt_cfg or AdamWConfig()
        opt_shape = _opt_shape(params_shape, opt_cfg)
        o_specs = shard_rules.zero_opt_specs(params_shape, p_specs, mesh)
        train_step = _train_step(
            lambda p, b: tf.loss_fn(p, b["tokens"], b["labels"], cfg),
            opt_cfg)
        state_shape = {"params": params_shape, "opt": opt_shape}
        state_specs = {"params": p_specs, "opt": o_specs}
        batch_specs = {k: batch_spec for k in inputs}
        return Cell(arch_id, shape_id, "train", train_step,
                    (state_shape, inputs),
                    (_named(mesh, state_specs), _named(mesh, batch_specs)),
                    (_named(mesh, state_specs), _named(mesh, _MET_SPECS)),
                    flops, donate=(0,), **common)

    cache_specs = shard_rules.lm_cache_specs(cfg, mesh, shape.global_batch)
    out_specs = (P(shard_rules.batch_axes(mesh), None),
                 cache_specs["k"], cache_specs["v"])

    if shape.kind == "prefill":
        def prefill_fn(params, batch, attend=None):
            with torch.inference_mode():
                logits, cache = tf.prefill(params, batch["tokens"], cfg,
                                           attend=attend)
            return logits, tuple(cache["k"]), tuple(cache["v"])

        in_specs = {k: batch_spec for k in inputs}
        return Cell(arch_id, shape_id, "prefill", prefill_fn,
                    (params_shape, inputs),
                    (_named(mesh, p_specs), _named(mesh, in_specs)),
                    _named(mesh, out_specs), flops, **common)

    # decode: one token against a full cache, written in place
    def decode_fn(params, batch, attend=None):
        ck, cv = batch["cache_k"], batch["cache_v"]
        per_layer = isinstance(ck, (tuple, list))
        cache = {"k": list(ck) if per_layer else list(ck.unbind(0)),
                 "v": list(cv) if per_layer else list(cv.unbind(0)),
                 "len": _cache_len(batch["cache_len"], shape.seq_len)}
        with torch.inference_mode():
            logits, _ = tf.decode_step(params, batch["tokens"], cache, cfg,
                                       attend=attend)
        return logits, ck, cv

    in_batch_specs = {
        "tokens": batch_spec,
        "cache_k": cache_specs["k"], "cache_v": cache_specs["v"],
        "cache_len": P(),
    }
    return Cell(arch_id, shape_id, "decode", decode_fn,
                (params_shape, inputs),
                (_named(mesh, p_specs), _named(mesh, in_batch_specs)),
                _named(mesh, out_specs), flops, donate=(1,), **common)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

_GNN_MODULES = {
    "gcn-cora": m_gcn, "pna": m_pna, "dimenet": m_dimenet,
    "meshgraphnet": m_mgn,
}


def _gnn_config(arch_id: str, shape) -> Any:
    """The full config of ``arch_id`` sized by a ``GNNShape``'s feature
    width (and class count, where the model classifies)."""
    spec = get_arch(arch_id)
    if arch_id in ("gcn-cora", "pna"):
        return spec.make_config(d_in=shape.d_feat, n_classes=shape.n_classes)
    if arch_id == "dimenet":
        return spec.make_config(d_in=shape.d_feat)
    if arch_id == "meshgraphnet":
        return spec.make_config(d_node_in=shape.d_feat)
    raise KeyError(arch_id)


def _gnn_cell(arch_id: str, shape_id, mesh, *,
              opt_cfg: Optional[AdamWConfig] = None,
              edges_packed: bool = False,
              gnn_cfg_overrides: Optional[dict] = None) -> Cell:
    """A GNN cell on a catalog shape (``shape_id`` names one of
    ``GNN_SHAPES``) or on a ``GNNShape`` outside the catalog (a
    dataset's own sizes); the cell's ``shape_id`` is the shape's name."""
    shape = shape_id if isinstance(shape_id, GNNShape) \
        else GNN_SHAPES[shape_id]
    shape_id = shape.name
    mod = _GNN_MODULES[arch_id]
    cfg = _gnn_config(arch_id, shape)
    if gnn_cfg_overrides:
        cfg = dataclasses.replace(cfg, **gnn_cfg_overrides)
    inputs = gnn_input_specs(shape, arch_id)
    cb_b = 0
    if edges_packed:
        # the edge index arrives CompBin-packed (paper eq. (1): b =
        # ceil(log2 |V| / 8) bytes an id) and is decoded on the device
        # right before the gather
        from repro_torch.core.compbin import bytes_per_vertex
        cb_b = bytes_per_vertex(shape.n_nodes)
        E = inputs["edge_src"].shape[0]
        packed = sds((E * cb_b,), torch.uint8)
        inputs = dict(inputs, edge_src=packed, edge_dst=packed)
    flops = mf.gnn_model_flops(arch_id, cfg, shape)

    params_shape = _abstract_init(lambda g: mod.init_params(cfg, g))
    p_specs = _replicated_specs(params_shape)
    b_specs = shard_rules.gnn_specs(mesh, inputs)
    static = {k: v for k, v in inputs.items()
              if not isinstance(v, torch.Tensor)}

    opt_cfg = opt_cfg or AdamWConfig()
    opt_shape = _opt_shape(params_shape, opt_cfg)
    o_specs = shard_rules.zero_opt_specs(params_shape, p_specs, mesh)

    loss_with_static = functools.partial(
        _gnn_loss, mod=mod, cfg=cfg,
        static=dict(static, n_graphs=shape.n_graphs), cb_b=cb_b)
    train_step = _train_step(loss_with_static, opt_cfg)

    arr_inputs = {k: v for k, v in inputs.items()
                  if isinstance(v, torch.Tensor)}
    state_shape = {"params": params_shape, "opt": opt_shape}
    state_specs = {"params": p_specs, "opt": o_specs}
    return Cell(arch_id, shape_id, "train", train_step,
                (state_shape, arr_inputs),
                (_named(mesh, state_specs), _named(mesh, b_specs)),
                (_named(mesh, state_specs), _named(mesh, _MET_SPECS)),
                flops, donate=(0,), compute_dtype=cfg.dtype, cfg=cfg)


def decode_packed_edges(batch: dict, cb_b: int) -> dict:
    """``batch`` with its packed ``edge_src`` / ``edge_dst`` decoded by
    the CompBin decode op (K1 on a CUDA tensor, its plain version on a
    CPU one), padding slots (id ``2^(8 cb_b) - 1``) mapped back to -1."""
    from repro_torch.kernels.compbin_decode import compbin_decode
    pad = (1 << (8 * cb_b)) - 1
    out = dict(batch)
    for key in ("edge_src", "edge_dst"):
        ids = compbin_decode(batch[key], cb_b)
        out[key] = torch.where(ids == pad, -1, ids)
    return out


def _gnn_loss(params, batch, *, mod, cfg, static, cb_b=0):
    """The GNN's loss on ``batch`` with ``static`` added; with ``cb_b``
    the packed edge ids are decoded first (:func:`decode_packed_edges`).
    The JAX package decodes here with its jnp oracle: the same
    contract."""
    full = decode_packed_edges(batch, cb_b) if cb_b else dict(batch)
    full.update(static)
    return mod.loss_fn(params, full, cfg)


# ---------------------------------------------------------------------------
# Recsys (DIN) cells
# ---------------------------------------------------------------------------

def _din_cell(arch_id: str, shape_id: str, mesh, *,
              opt_cfg: Optional[AdamWConfig] = None) -> Cell:
    spec = get_arch(arch_id)
    shape = RECSYS_SHAPES[shape_id]
    cfg = spec.make_config()
    inputs = din_input_specs(shape, cfg)
    flops = mf.din_model_flops(cfg, shape)
    params_shape = _abstract_init(lambda g: m_din.init_params(cfg, g))
    p_specs = shard_rules.din_specs(params_shape, mesh)
    b_specs = shard_rules.din_batch_specs(mesh, inputs)
    common = dict(compute_dtype=cfg.dtype, cfg=cfg)

    if shape.kind == "train":
        opt_cfg = opt_cfg or AdamWConfig()
        opt_shape = _opt_shape(params_shape, opt_cfg)
        o_specs = shard_rules.zero_opt_specs(params_shape, p_specs, mesh)
        train_step = _train_step(lambda p, b: m_din.loss_fn(p, b, cfg),
                                 opt_cfg)
        state_shape = {"params": params_shape, "opt": opt_shape}
        state_specs = {"params": p_specs, "opt": o_specs}
        return Cell(arch_id, shape_id, "train", train_step,
                    (state_shape, inputs),
                    (_named(mesh, state_specs), _named(mesh, b_specs)),
                    (_named(mesh, state_specs), _named(mesh, _MET_SPECS)),
                    flops, donate=(0,), **common)

    if shape.kind == "retrieval":
        def retrieve(params, batch):
            with torch.inference_mode():
                return m_din.score_candidates(params, batch, cfg)

        out_spec = P(tuple(mesh.axis_names))
        return Cell(arch_id, shape_id, "retrieval", retrieve,
                    (params_shape, inputs),
                    (_named(mesh, p_specs), _named(mesh, b_specs)),
                    _named(mesh, out_spec), flops, **common)

    def serve(params, batch):
        with torch.inference_mode():
            return m_din.forward(params, batch, cfg)

    out_spec = P(shard_rules.batch_axes(mesh))
    return Cell(arch_id, shape_id, "serve", serve,
                (params_shape, inputs),
                (_named(mesh, p_specs), _named(mesh, b_specs)),
                _named(mesh, out_spec), flops, **common)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def build_cell(arch_id: str, shape_id, mesh, **kw) -> Cell:
    """The cell (``arch_id``, ``shape_id``) on ``mesh`` (a
    :class:`repro_torch.launch.mesh.Mesh`); ``kw`` as
    :func:`repro_torch.launch.variants.apply_variant` gives them
    (``cfg_overrides``, ``edges_packed``, ``gnn_cfg_overrides``,
    ``opt_cfg``, ``unroll``).  A GNN's ``shape_id`` may also be a
    :class:`~repro_torch.configs.shapes.GNNShape` outside the catalog."""
    family = get_arch(arch_id).family
    if isinstance(shape_id, GNNShape) and family != "gnn":
        raise TypeError(f"{arch_id} is not a GNN: a GNNShape does not "
                        f"size it")
    if family == "lm":
        return _lm_cell(arch_id, shape_id, mesh, **kw)
    kw.pop("unroll", None)  # GNN/recsys models have no layer loop to unroll
    if family == "gnn":
        return _gnn_cell(arch_id, shape_id, mesh, **kw)
    return _din_cell(arch_id, shape_id, mesh, **kw)
