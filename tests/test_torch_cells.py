"""The port's cell layer against the JAX package's, on the CPU: input
specs, the spec builders of ``distributed/sharding.py``, the variants,
``build_cell`` and the abstract outputs of every cell, then cell steps
executed in both packages on the same inputs.

Specs: shapes equal on all 40 cells; dtypes equal but where the port
widens ids (LM ``tokens`` / ``labels`` and DIN ids are int64, int32 in
the JAX package).  Spec trees equal as tuples for all 10 archs on the
1x1, 4x2, 16x16 and 2x16x16 meshes (the JAX side from ``jax.eval_shape``
params on a stand-in mesh: its builders read only axis names and
sizes).  Executed steps, on the JAX package's weights
(``convert.py``): the four GNNs on ``full_graph_sm`` / ``molecule`` (at
the reduced hidden widths through ``gnn_cfg_overrides``, gcn-cora at its
full width: ``STEP_WIDTHS``), loss
within 1e-5 and gradients within rtol 1e-4 / atol 1e-6 x max|g| (PNA's,
whose std aggregator cancels in f32, taken in float64 in both
packages); ``gcn-cora`` under ``edges_compbin``, the decoded ids equal
as integers; an LM prefill on the reduced smollm-360m through
``cfg_overrides`` and real ``[2, 16]`` tokens, logits and caches within
3e-4; DIN's serve step on the reduced config's weights within 1e-5."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_cells as ref_all_cells
from repro.configs import get_arch as ref_get_arch
from repro.configs import shapes as ref_shapes
from repro.distributed import sharding as ref_sharding
from repro.launch import steps as ref_steps
from repro.launch import variants as ref_variants
from repro.models import transformer as ref_tf
from repro.models.recsys import din as ref_din
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.configs import all_cells, get_arch, shapes
from repro_torch.convert import (adamw_state_from_numpy,
                                 din_params_from_numpy, gnn_params_from_numpy,
                                 transformer_params_from_numpy)
from repro_torch.distributed import sharding
from repro_torch.launch import steps, variants
from repro_torch.launch.mesh import Mesh, card_mesh, make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import adamw_init, tree_leaves, tree_map

CELLS = all_cells()
RUNNABLE = [c for c in CELLS if c[1] != "long_500k"]
#: the JAX package's int32 ids the port carries as int64
WIDENED = {("lm", "tokens"), ("lm", "labels"), ("recsys", "hist_items"),
           ("recsys", "hist_cates"), ("recsys", "cand_item"),
           ("recsys", "cand_cate"), ("recsys", "cand_items"),
           ("recsys", "cand_cates")}
MESHES = {"1x1": (("data", "model"), (1, 1)),
          "4x2": (("data", "model"), (4, 2)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
TOL = 1e-5
GRAD_RTOL, GRAD_SHARE = 1e-4, 1e-6
LM_TOL = 3e-4
#: the executed GNN steps' hidden widths and depths (the reduced
#: configs'; the input widths stay the cell's): at the full widths
#: random inputs drive MeshGraphNet's 15 residual layers and DimeNet's
#: 6 blocks to gradients of 1e5-1e9, whose f32 rounding no tolerance of
#: either package's tests bounds; the card holds the full widths to a
#: float64 run (``chip_smoke.py``'s ``[gnn2]`` and ``[cells]``)
STEP_WIDTHS = {"gcn-cora": {},
               "pna": dict(n_layers=2, d_hidden=12),
               "meshgraphnet": dict(n_layers=2, d_hidden=16),
               "dimenet": dict(n_blocks=2, d_hidden=16, n_bilinear=4,
                               n_spherical=3, n_radial=3)}


class RefMesh:
    """What the JAX package's spec builders read of a mesh: axis names
    and ``devices.shape``."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.devices = np.empty(sizes, dtype=object)


def _dtype(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).split(".")[-1]
    return np.dtype(dt).name


def _norm(tree):
    """A spec tree of either package as plain data."""
    if isinstance(tree, sharding.P):
        return ("P", tuple(tree))
    if isinstance(tree, jax.sharding.PartitionSpec):
        return ("P", tuple(tree))
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_norm(v) for v in tree]
    return tree


@pytest.fixture(scope="module")
def ref_mesh():
    from jax.sharding import Mesh as JMesh
    return JMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def test_catalogs_match():
    assert all_cells() == ref_all_cells() and len(CELLS) == 40
    assert shapes.NODE_PAD == ref_shapes.NODE_PAD
    assert shapes.EDGE_PAD == ref_shapes.EDGE_PAD


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def _input_specs(arch, shape_id, unroll):
    family = get_arch(arch).family
    if family == "lm":
        cfg = dataclasses.replace(get_arch(arch).make_config(),
                                  unroll_layers=unroll)
        rcfg = dataclasses.replace(ref_get_arch(arch).make_config(),
                                   unroll_layers=unroll)
        return (family, shapes.lm_input_specs(shapes.LM_SHAPES[shape_id], cfg),
                ref_shapes.lm_input_specs(ref_shapes.LM_SHAPES[shape_id],
                                          rcfg))
    if family == "gnn":
        return (family, shapes.gnn_input_specs(shapes.GNN_SHAPES[shape_id],
                                               arch),
                ref_shapes.gnn_input_specs(ref_shapes.GNN_SHAPES[shape_id],
                                           arch))
    return (family, shapes.din_input_specs(shapes.RECSYS_SHAPES[shape_id],
                                           get_arch(arch).make_config()),
            ref_shapes.din_input_specs(ref_shapes.RECSYS_SHAPES[shape_id],
                                       ref_get_arch(arch).make_config()))


@pytest.mark.parametrize("unroll", [True, False], ids=["layered", "stacked"])
@pytest.mark.parametrize("arch,shape_id", CELLS)
def test_input_specs_match(arch, shape_id, unroll):
    family, got, want = _input_specs(arch, shape_id, unroll)
    assert list(got) == list(want)
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, tuple):                   # per-layer caches
            assert isinstance(g, tuple) and len(g) == len(w)
            pairs = list(zip(g, w))
        else:
            pairs = [(g, w)]
        for gt, wt in pairs:
            assert gt.device.type == "meta"
            assert tuple(gt.shape) == tuple(wt.shape), key
            want_dt = "int64" if (family, key) in WIDENED else _dtype(wt.dtype)
            if (family, key) in WIDENED:
                assert _dtype(wt.dtype) == "int32", key
            assert _dtype(gt.dtype) == want_dt, key


# ---------------------------------------------------------------------------
# spec builders
# ---------------------------------------------------------------------------

def _params_pair(arch):
    """(port meta params, JAX ``eval_shape`` params) of ``arch``'s full
    config (GNNs at the ``full_graph_sm`` widths)."""
    spec, rspec = get_arch(arch), ref_get_arch(arch)
    if spec.family == "lm":
        cfg, rcfg = spec.make_config(), rspec.make_config()
        return (steps._abstract_init(lambda g: tf.init_params(cfg, g)),
                jax.eval_shape(lambda k: ref_tf.init_params(rcfg, k),
                               jax.random.key(0)), cfg, rcfg)
    if spec.family == "gnn":
        shp = shapes.GNN_SHAPES["full_graph_sm"]
        cfg = steps._gnn_config(arch, shp)
        rcfg = ref_steps._gnn_config(arch, ref_shapes.GNN_SHAPES[
            "full_graph_sm"])
        mod, rmod = steps._GNN_MODULES[arch], ref_steps._GNN_MODULES[arch]
        return (steps._abstract_init(lambda g: mod.init_params(cfg, g)),
                jax.eval_shape(lambda k: rmod.init_params(rcfg, k),
                               jax.random.key(0)), cfg, rcfg)
    cfg, rcfg = spec.make_config(), rspec.make_config()
    from repro_torch.models.recsys import din
    return (steps._abstract_init(lambda g: din.init_params(cfg, g)),
            jax.eval_shape(lambda k: ref_din.init_params(rcfg, k),
                           jax.random.key(0)), cfg, rcfg)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", list(dict.fromkeys(a for a, _ in CELLS)))
def test_spec_builders_match(arch, mesh_id):
    names, sizes = MESHES[mesh_id]
    mesh, rmesh = Mesh(names, sizes), RefMesh(names, sizes)
    for axis in ("pod", "data", "model", "none"):
        assert sharding.axis_size(mesh, axis) == \
            ref_sharding.axis_size(rmesh, axis)
    assert _norm(sharding.batch_axes(mesh)) == \
        _norm(ref_sharding.batch_axes(rmesh))
    params, rparams, cfg, rcfg = _params_pair(arch)
    family = get_arch(arch).family
    built = []
    if family == "lm":
        p_specs = sharding.lm_param_specs(cfg, mesh)
        rp_specs = ref_sharding.lm_param_specs(rcfg, rmesh)
        built += [(p_specs, rp_specs),
                  (sharding.lm_batch_spec(mesh),
                   ref_sharding.lm_batch_spec(rmesh))]
        for unroll in (True, False):
            for batch in (32, 7):
                built.append((sharding.lm_cache_specs(
                    dataclasses.replace(cfg, unroll_layers=unroll), mesh,
                    batch), ref_sharding.lm_cache_specs(
                    dataclasses.replace(rcfg, unroll_layers=unroll), rmesh,
                    batch)))
    elif family == "gnn":
        p_specs = steps._replicated_specs(params)
        rp_specs = ref_steps._replicated_specs(rparams)
        for shape_id in ("full_graph_sm", "molecule"):
            _, got, want = _input_specs(arch, shape_id, True)
            built.append((sharding.gnn_specs(mesh, got),
                          ref_sharding.gnn_specs(rmesh, want)))
    else:
        p_specs = sharding.din_specs(params, mesh)
        rp_specs = ref_sharding.din_specs(rparams, rmesh)
        built += [(p_specs, rp_specs),
                  (sharding.din_param_specs(mesh),
                   ref_sharding.din_param_specs(rmesh))]
        for shape_id in ("train_batch", "retrieval_cand"):
            _, got, want = _input_specs(arch, shape_id, True)
            built.append((sharding.din_batch_specs(mesh, got),
                          ref_sharding.din_batch_specs(rmesh, want)))
    built.append((sharding.zero_opt_specs(params, p_specs, mesh),
                  ref_sharding.zero_opt_specs(rparams, rp_specs, rmesh)))
    for p, rp, s, rs in zip(tree_leaves(params),
                            jax.tree_util.tree_leaves(rparams),
                            sharding.spec_leaves(p_specs),
                            jax.tree_util.tree_leaves(
                                rp_specs, is_leaf=lambda x: isinstance(
                                    x, jax.sharding.PartitionSpec))):
        assert tuple(p.shape) == tuple(rp.shape)
        built.append((sharding.zero_spec(tuple(p.shape), s, mesh),
                      ref_sharding.zero_spec(rp.shape, rs, rmesh)))
    for got, want in built:
        assert _norm(got) == _norm(want)
    # named(): one placement per mesh dim for every spec
    for leaf in sharding.spec_leaves(p_specs):
        assert len(sharding.named(mesh, leaf)) == len(names)


def test_named_places_the_pod_axis_major_as_jax_does(tmp_path):
    """A tensor dim sharded over ("pod", "data") or over every axis: the
    DTensor offsets of each mesh coordinate equal the offsets JAX gives
    the device at that coordinate (8 host devices, a 2x2x2 mesh)."""
    import itertools
    import json
    import os
    import subprocess
    import sys

    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset

    specs = [(("pod", "data"), None), (("pod", "data", "model"),),
             (("data", "model"), None), (None, ("pod", "model"))]
    shape = (16, 8)
    code = (
        "import json, numpy as np, jax\n"
        "from jax.sharding import Mesh, NamedSharding, PartitionSpec as P\n"
        "m = Mesh(np.array(jax.devices()).reshape(2, 2, 2), "
        "('pod', 'data', 'model'))\n"
        f"specs = {specs!r}\n"
        "out = []\n"
        "for s in specs:\n"
        f"    shp = {shape!r}[:len(s)]\n"
        "    idx = NamedSharding(m, P(*s)).devices_indices_map(shp)\n"
        "    out.append({','.join(str(int(i)) for i in "
        "np.argwhere(m.devices == d)[0]): "
        "[sl.start or 0 for sl in v] for d, v in idx.items()})\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    want = json.loads(res.stdout.strip().splitlines()[-1])
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2))
    for s, w in zip(specs, want):
        pl = sharding.placements(mesh, sharding.P(*s))
        shp = shape[:len(s)]
        for coord in itertools.product(range(2), range(2), range(2)):
            _, offset = _compute_local_shape_and_global_offset(
                shp, (2, 2, 2), list(coord), pl)
            assert list(offset) == w[",".join(map(str, coord))], (s, coord)


def test_placements_refuse_an_order_dtensor_cannot_split():
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2))
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements(mesh, sharding.P(("data", "pod")))
    with pytest.raises(ValueError, match="not in"):
        sharding.placements(mesh, sharding.P("expert"))


# ---------------------------------------------------------------------------
# variants and cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["baseline", *ref_variants.VARIANTS])
def test_apply_variant_matches(name):
    assert list(variants.VARIANTS) == list(ref_variants.VARIANTS)
    for arch, shape_id in (("dbrx-132b", "decode_32k"),
                           ("gcn-cora", "ogb_products")):
        assert variants.apply_variant(arch, shape_id, name) == \
            ref_variants.apply_variant(arch, shape_id, name)


def test_unknown_variant_raises():
    with pytest.raises(KeyError, match="unknown variant"):
        variants.apply_variant("gcn-cora", "molecule", "nope")


def _ref_placements(mesh, tree):
    """The JAX cell's NamedSharding tree as the port's placements."""
    if isinstance(tree, jax.sharding.NamedSharding):
        return sharding.placements(mesh, sharding.P(*tree.spec))
    if isinstance(tree, dict):
        return {k: _ref_placements(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_ref_placements(mesh, v) for v in tree)
    return tree


@pytest.mark.parametrize("arch,shape_id", CELLS)
def test_build_cell_matches(arch, shape_id, ref_mesh):
    cell = steps.build_cell(arch, shape_id, card_mesh())
    ref = ref_steps.build_cell(arch, shape_id, ref_mesh)
    assert cell.kind == ref.kind and cell.skip_reason == ref.skip_reason
    assert cell.model_flops == pytest.approx(ref.model_flops, rel=1e-12)
    if ref.skip_reason:
        assert cell.fn is None and cell.args is None
        return
    assert cell.donate == ref.donate
    mesh = card_mesh()
    assert cell.in_shardings == _ref_placements(mesh, ref.in_shardings)
    assert cell.out_shardings == _ref_placements(mesh, ref.out_shardings)
    got = [tuple(t.shape) for t in tree_leaves(cell.args)]
    want = [tuple(t.shape) for t in jax.tree_util.tree_leaves(ref.args)]
    assert got == want


def test_lm_cells_set_the_mesh_fields():
    mesh = make_production_mesh(multi_pod=True)
    cell = steps.build_cell("qwen2-1.5b", "train_4k", mesh, unroll=False)
    cfg = cell.cfg
    assert cfg.attn_head_axis == "model" and cfg.attn_kv_expand
    assert cfg.batch_axes == ("pod", "data") and not cfg.unroll_layers
    moe = steps.build_cell("dbrx-132b", "prefill_32k", card_mesh()).cfg
    assert moe.moe_ep_axis == "model" and not moe.attn_kv_expand


def _out_shapes(tree, leaves):
    return [tuple(t.shape) for t in leaves(tree)]


@pytest.mark.parametrize("arch,shape_id", [
    pytest.param(a, s, marks=pytest.mark.slow)
    if get_arch(a).family == "lm" else (a, s) for a, s in RUNNABLE])
def test_abstract_outputs_match_eval_shape(arch, shape_id, ref_mesh):
    """The abstract trace's outputs against ``jax.eval_shape`` of the JAX
    cell (the per-layer caches of its unrolled LM cells included); the
    LM cells trace tens of thousands of ops, so they run with ``-m
    slow``."""
    cell = steps.build_cell(arch, shape_id, card_mesh())
    ref = ref_steps.build_cell(arch, shape_id, ref_mesh)
    got = steps._abstract(cell.fn, *cell.args)
    with ref_mesh:
        want = jax.eval_shape(ref.fn, *ref.args)
    assert _out_shapes(got, tree_leaves) == \
        _out_shapes(want, jax.tree_util.tree_leaves)
    assert all(t.device.type == "cpu" for t in tree_leaves(got)
               if isinstance(t, torch.Tensor))


def test_card_attention_footprint_holds_no_scores():
    """The card-path trace of a prefill holds the kernel's output, not
    the plain attention's [S, S] tiles; the plain trace is untouched."""
    from repro_torch.launch.dryrun import trace_cell
    cell = steps.build_cell("smollm-360m", "prefill_32k", card_mesh(),
                            cfg_overrides={"n_layers": 1})
    plain = trace_cell(cell)["cost"].peak_live
    card = trace_cell(cell, card=True)["cost"].peak_live
    scores = 32 * 15 * 8192 * 8192 * 4        # one f32 tile of scores
    assert plain > scores > card
    assert trace_cell(cell)["cost"].peak_live == plain


# ---------------------------------------------------------------------------
# executed cells
# ---------------------------------------------------------------------------

def _gnn_inputs(cell, rng, n_nodes, n_edges, n_graphs, cb_b=0):
    """Real inputs for a GNN cell's batch specs: ids in range on the
    real edges / nodes and -1 in the padding, random features."""
    batch = {}
    specs = cell.args[1]
    for key, spec in specs.items():
        shp = tuple(spec.shape)
        if key in ("edge_src", "edge_dst"):
            e = shp[0] // cb_b if cb_b else shp[0]
            ids = np.full(e, -1, np.int64)
            ids[:n_edges] = rng.integers(0, n_nodes, n_edges)
            batch[key] = ids
        elif key.startswith("triplet_"):
            ids = np.full(shp[0], -1, np.int64)
            real = min(shp[0], 4 * n_edges)
            ids[:real] = rng.integers(0, n_edges, real)
            batch[key] = ids
        elif key == "graph_id":
            g = np.full(shp[0], -1, np.int64)
            g[:n_nodes] = np.sort(rng.integers(0, n_graphs, n_nodes))
            batch[key] = g
        elif key == "labels":
            batch[key] = rng.integers(0, cell.cfg.n_classes, shp)
        elif spec.dtype == torch.bool:
            m = rng.random(shp) < 0.5
            m[n_nodes:] = False
            batch[key] = m
        else:
            batch[key] = rng.standard_normal(shp).astype(np.float32)
    return batch


def _port_batch(batch, specs, cb_b=0):
    out = {}
    for k, v in batch.items():
        if cb_b and k in ("edge_src", "edge_dst"):
            out[k] = torch.from_numpy(_packed(v, cb_b))
        else:
            out[k] = torch.from_numpy(v).to(specs[k].dtype)
    return out


def _packed(ids: np.ndarray, b: int) -> np.ndarray:
    """Little-endian b-byte ids, -1 as the all-ones pad id."""
    u = np.where(ids < 0, (1 << (8 * b)) - 1, ids).astype(np.uint64)
    return np.stack([(u >> np.uint64(8 * i)) & np.uint64(255)
                     for i in range(b)], axis=1).astype(np.uint8).reshape(-1)


def _ref_batch(batch, rspecs, cb_b=0):
    out = {}
    for k, v in batch.items():
        if cb_b and k in ("edge_src", "edge_dst"):
            out[k] = jnp.asarray(_packed(v, cb_b))
        else:
            out[k] = jnp.asarray(v, rspecs[k].dtype)
    return out


def _ref64_grads(rloss, rparams, rbatch):
    """The JAX package's gradients of ``rloss`` (a function of the
    params, the batch and the float64 config) in float64."""
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float64),
                                     rparams)
        b64 = {k: (jnp.asarray(v, jnp.float64)
                   if np.asarray(v).dtype == np.float32 else v)
               for k, v in rbatch.items()}
        return [np.asarray(g) for g in
                jax.tree_util.tree_leaves(jax.jit(jax.grad(rloss))(p64, b64))]


def _segment_sum_f64(messages, segment_ids, num_segments):
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    out = torch.zeros(num_segments, messages.shape[1], dtype=torch.float64)
    return out.index_add_(0, torch.where(valid, segment_ids, 0).long(),
                          torch.where(valid[:, None], messages.double(), 0.0))


def _port64_grads(loss, cfg, params, batch):
    """The port's gradients of the cell's loss in float64: params, float
    inputs and config float64, every segment sum in float64."""
    from repro_torch.models.gnn import layers
    p = tree_map(lambda t: t.detach().double().requires_grad_(), params)
    b = {k: v.double() if v.is_floating_point() else v
         for k, v in batch.items()}
    real = layers.segment_sum
    layers.segment_sum = _segment_sum_f64
    try:
        l = loss(p, b, cfg=dataclasses.replace(cfg, dtype=torch.float64))
        return [g.numpy() for g in torch.autograd.grad(l, tree_leaves(p))]
    finally:
        layers.segment_sum = real


def _gnn_pair(arch, shape_id, ref_mesh, **kw):
    cell = steps.build_cell(arch, shape_id, card_mesh(), **kw)
    ref = ref_steps.build_cell(arch, shape_id, ref_mesh, **kw)
    shp = shapes.GNN_SHAPES[shape_id]
    rcfg = ref_steps._gnn_config(arch, ref_shapes.GNN_SHAPES[shape_id])
    if kw.get("gnn_cfg_overrides"):
        rcfg = dataclasses.replace(rcfg, **kw["gnn_cfg_overrides"])
    rparams = ref_steps._GNN_MODULES[arch].init_params(rcfg,
                                                       jax.random.key(0))
    params = gnn_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          rparams), "cpu")
    cb_b = 0
    if kw.get("edges_packed"):
        from repro_torch.core.compbin import bytes_per_vertex
        cb_b = bytes_per_vertex(shp.n_nodes)
    batch = _gnn_inputs(cell, np.random.default_rng(3), shp.n_nodes,
                        shp.n_edges, shp.n_graphs, cb_b)
    return cell, ref, rcfg, rparams, params, batch, cb_b


@pytest.mark.parametrize("arch,shape_id", [
    pytest.param(a, s, marks=pytest.mark.slow)
    if (a, s) == ("pna", "full_graph_sm") else (a, s)
    for a in ("gcn-cora", "pna", "meshgraphnet", "dimenet")
    for s in ("full_graph_sm", "molecule")])
def test_gnn_cell_steps_match(arch, shape_id, ref_mesh):
    """One training step of the cell in both packages: the loss and
    grad norm of the step, and every gradient of the cell's loss
    (``STEP_WIDTHS``; gcn-cora at its full width).  PNA on
    ``full_graph_sm`` (two float64 runs, ~9 s) runs with ``-m slow``."""
    kw = {"gnn_cfg_overrides": STEP_WIDTHS[arch]} if STEP_WIDTHS[arch] \
        else {}
    cell, ref, rcfg, rparams, params, batch, _ = _gnn_pair(
        arch, shape_id, ref_mesh, **kw)
    shp = shapes.GNN_SHAPES[shape_id]
    pb = _port_batch(batch, cell.args[1])
    rb = _ref_batch(batch, ref.args[1])
    state = {"params": params, "opt": adamw_init(params, cell_opt())}
    rstate = {"params": rparams, "opt": ref_adamw_init(rparams,
                                                       RefAdamWConfig())}
    new, met = cell.fn(state, pb)
    with ref_mesh:
        rnew, rmet = jax.jit(ref.fn)(rstate, rb)
    assert float(met["loss"]) == pytest.approx(float(rmet["loss"]), rel=TOL)
    assert float(met["grad_norm"]) == pytest.approx(
        float(rmet["grad_norm"]), rel=GRAD_RTOL)
    assert int(new["opt"]["step"]) == int(rnew["opt"]["step"]) == 1
    # the gradients of the cell's loss
    static = {"n_graphs": shp.n_graphs}
    loss = functools.partial(steps._gnn_loss, mod=steps._GNN_MODULES[arch],
                             cfg=cell.cfg, static=static)
    rloss = functools.partial(ref_steps._gnn_loss,
                              mod=ref_steps._GNN_MODULES[arch], cfg=rcfg,
                              static=static)
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    grads = [g.numpy() for g in torch.autograd.grad(loss(p, pb),
                                                    tree_leaves(p))]
    rgrads = [np.asarray(g) for g in
              jax.tree_util.tree_leaves(jax.jit(jax.grad(rloss))(rparams,
                                                                 rb))]
    if arch == "pna":
        # the std aggregator's E[m^2] - E[m]^2 cancels: compare both
        # packages' float64 runs instead
        rloss64 = functools.partial(
            ref_steps._gnn_loss, mod=ref_steps._GNN_MODULES[arch],
            cfg=dataclasses.replace(rcfg, dtype=jnp.float64), static=static)
        rgrads = _ref64_grads(rloss64, rparams, rb)
        grads = _port64_grads(loss, cell.cfg, params, pb)
    for g, rg in zip(grads, rgrads, strict=True):
        np.testing.assert_allclose(g, rg, rtol=GRAD_RTOL,
                                   atol=GRAD_SHARE * np.abs(rg).max())


def cell_opt():
    from repro_torch.optim import AdamWConfig
    return AdamWConfig()


@pytest.mark.parametrize("shape_id", ["full_graph_sm", "minibatch_lg"])
def test_edges_compbin_cell_decodes_the_ids(shape_id, ref_mesh):
    """``gcn-cora`` under ``edges_compbin``: the packed edge ids the
    loss decodes (the CompBin decode op's plain version here, K1 on the
    card) equal the JAX package's oracle's as integers, -1 in the
    padding, and the step's loss equals the reference's."""
    from repro.kernels.compbin_decode.ref import compbin_decode_ref
    from repro_torch.kernels.compbin_decode import compbin_decode
    kw = variants.apply_variant("gcn-cora", shape_id, "edges_compbin")
    cell, ref, rcfg, rparams, params, batch, b = _gnn_pair(
        "gcn-cora", shape_id, ref_mesh, **kw)
    assert b == (2 if shape_id == "full_graph_sm" else 3)
    assert cell.args[1]["edge_src"].dtype == torch.uint8
    pb = _port_batch(batch, cell.args[1], b)
    rb = _ref_batch(batch, ref.args[1], b)
    pad = (1 << (8 * b)) - 1
    for key in ("edge_src", "edge_dst"):
        got = compbin_decode(pb[key], b)
        got = torch.where(got == pad, -1, got).long().numpy()
        want = np.asarray(compbin_decode_ref(rb[key], b)).astype(np.int64)
        want = np.where(want == pad, -1, want)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, batch[key])
    state = {"params": params, "opt": adamw_init(params, cell_opt())}
    rstate = {"params": rparams, "opt": ref_adamw_init(rparams,
                                                       RefAdamWConfig())}
    _, met = cell.fn(state, pb)
    with ref_mesh:
        _, rmet = jax.jit(ref.fn)(rstate, rb)
    assert float(met["loss"]) == pytest.approx(float(rmet["loss"]), rel=TOL)


def _reduced_overrides(arch, torch_side: bool) -> dict:
    red = (get_arch if torch_side else ref_get_arch)(arch).make_reduced()
    keep = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff",
            "vocab", "max_seq", "qkv_bias", "norm", "rope_pct",
            "tie_embeddings")
    over = {k: getattr(red, k) for k in keep}
    over["dtype"] = torch.float32 if torch_side else jnp.float32
    return over


def test_lm_prefill_cell_matches(ref_mesh):
    """The prefill cell's step on the reduced smollm-360m (through
    ``cfg_overrides``) and real [2, 16] tokens, on the JAX weights."""
    arch = "smollm-360m"
    cell = steps.build_cell(arch, "prefill_32k", card_mesh(),
                            cfg_overrides=_reduced_overrides(arch, True))
    ref = ref_steps.build_cell(arch, "prefill_32k", ref_mesh,
                               cfg_overrides=_reduced_overrides(arch, False))
    rcfg = dataclasses.replace(ref_get_arch(arch).make_config(),
                               **_reduced_overrides(arch, False))
    rparams = ref_tf.init_params(rcfg, jax.random.key(0))
    params = transformer_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), cell.cfg, "cpu")
    tokens = np.random.default_rng(5).integers(0, rcfg.vocab, (2, 16))
    got = cell.fn(params, {"tokens": torch.from_numpy(tokens)})
    with ref_mesh:
        want = jax.jit(ref.fn)(rparams, {"tokens": jnp.asarray(tokens,
                                                               jnp.int32)})
    got_l, want_l = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l) == 1 + 2 * rcfg.n_layers
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LM_TOL,
                                   atol=LM_TOL)


def test_lm_decode_cell_reads_the_cache_len(ref_mesh):
    """The decode cell's step writes the token at ``cache_len`` and
    returns the caches it was given (per layer), as the JAX cell does."""
    arch = "smollm-360m"
    over = _reduced_overrides(arch, True)
    cell = steps.build_cell(arch, "decode_32k", card_mesh(),
                            cfg_overrides=over)
    ref = ref_steps.build_cell(arch, "decode_32k", ref_mesh,
                               cfg_overrides=_reduced_overrides(arch, False))
    rcfg = dataclasses.replace(ref_get_arch(arch).make_config(),
                               **_reduced_overrides(arch, False))
    rparams = ref_tf.init_params(rcfg, jax.random.key(0))
    params = transformer_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), cell.cfg, "cpu")
    rng = np.random.default_rng(6)
    B, S, L = 2, 12, rcfg.n_layers
    kv = rng.standard_normal((2, L, B, S, rcfg.n_kv_heads,
                              rcfg.d_head)).astype(np.float32)
    tok = rng.integers(0, rcfg.vocab, (B, 1))
    pb = {"tokens": torch.from_numpy(tok),
          "cache_k": tuple(torch.from_numpy(kv[0, i].copy())
                           for i in range(L)),
          "cache_v": tuple(torch.from_numpy(kv[1, i].copy())
                           for i in range(L)),
          "cache_len": torch.tensor(7, dtype=torch.int32)}
    rb = {"tokens": jnp.asarray(tok, jnp.int32),
          "cache_k": tuple(jnp.asarray(kv[0, i]) for i in range(L)),
          "cache_v": tuple(jnp.asarray(kv[1, i]) for i in range(L)),
          "cache_len": jnp.int32(7)}
    got = cell.fn(params, pb)
    with ref_mesh:
        want = jax.jit(ref.fn)(rparams, rb)
    assert got[1] is pb["cache_k"] and got[2] is pb["cache_v"]
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want),
                    strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LM_TOL,
                                   atol=LM_TOL)


def test_din_serve_cell_matches(ref_mesh):
    """DIN's serve step on the reduced config's weights and a batch of
    8 (the cell's model reads its layer names from the config: the
    reduced and full DIN have the same layers)."""
    cell = steps.build_cell("din", "serve_p99", card_mesh())
    ref = ref_steps.build_cell("din", "serve_p99", ref_mesh)
    rcfg = ref_get_arch("din").make_reduced()
    rparams = ref_din.init_params(rcfg, jax.random.key(0))
    params = din_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          rparams), "cpu")
    rng = np.random.default_rng(7)
    B, S = 8, rcfg.seq_len
    items = rng.integers(-1, rcfg.n_items, (B, S))
    cates = rng.integers(0, rcfg.n_cates, (B, S))
    ci, cc = rng.integers(0, rcfg.n_items, B), rng.integers(0, rcfg.n_cates,
                                                           B)
    pb = {"hist_items": torch.from_numpy(items),
          "hist_cates": torch.from_numpy(cates),
          "cand_item": torch.from_numpy(ci), "cand_cate": torch.from_numpy(cc)}
    rb = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in pb.items()}
    got = cell.fn(params, pb)
    with ref_mesh:
        want = jax.jit(ref.fn)(rparams, rb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_train_cell_state_converts_both_ways(ref_mesh):
    """The DIN train cell's state tree is the JAX package's: its AdamW
    state converts leaf for leaf (``adamw_state_from_numpy``)."""
    cell = steps.build_cell("din", "train_batch", card_mesh())
    ref = ref_steps.build_cell("din", "train_batch", ref_mesh)
    rstate = jax.tree_util.tree_map(
        lambda s: np.zeros((1,) * len(s.shape) if s.shape else (),
                           s.dtype), ref.args[0]["opt"])
    st = adamw_state_from_numpy(rstate, "cpu")
    assert [t.ndim for t in tree_leaves(st)] == \
        [t.ndim for t in tree_leaves(cell.args[0]["opt"])]
