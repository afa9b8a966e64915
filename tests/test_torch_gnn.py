"""GCN and its layers: the port on CPU tensors against the JAX package on
the same numpy inputs and the JAX package's own weights (carried over by
``convert.gcn_params_from_numpy``).  Floats: rtol 1e-5, atol 1e-4 (f32
both sides, sums in another order).  Sampler blocks and edge lists are
integers: tolerance ZERO."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.graph import NeighborSampler as RefSampler
from repro.graph import rmat as ref_rmat
from repro.launch.data_gnn import block_to_edges as ref_block_to_edges
from repro.models.gnn import gcn as ref_gcn
from repro.models.gnn import layers as ref_layers
from repro_torch import configs as port_configs
from repro_torch.convert import csr_from_numpy, gcn_params_from_numpy
from repro_torch.graph import NeighborSampler as PortSampler
from repro_torch.launch.data_gnn import block_to_edges as port_block_to_edges
from repro_torch.launch.steps import _GNN_MODULES
from repro_torch.models.gnn import gcn as port_gcn
from repro_torch.models.gnn import layers as port_layers

RTOL, ATOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def graph():
    return ref_rmat(9, 8, seed=3)


def _blocks(graph, fanouts, n_seeds, seed=7, n=3):
    """The same seed batches through both samplers over the same CSR."""
    rs = RefSampler(graph, fanouts, seed=seed)
    ps = PortSampler(csr_from_numpy(graph.offsets, graph.neighbors), fanouts,
                     seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(n):
        seeds = rng.integers(0, graph.n_vertices, n_seeds)
        yield rs.sample(seeds), ps.sample(seeds)


@pytest.mark.parametrize("fanouts", [(5, 5), (3, 2), (4,)])
def test_sampler_blocks_and_edges_are_integer_equal(graph, fanouts):
    for rb, pb in _blocks(graph, fanouts, 16):
        assert pb.fanouts == rb.fanouts and pb.num_nodes() == rb.num_nodes()
        np.testing.assert_array_equal(pb.seeds, rb.seeds)
        for a, b in zip(pb.layer_nodes, rb.layer_nodes):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(pb.layer_valid, rb.layer_valid):
            np.testing.assert_array_equal(a, b)
        ps, pd, pn = port_block_to_edges(pb)
        rs, rd, rn = ref_block_to_edges(rb)
        assert pn == rn
        np.testing.assert_array_equal(ps, rs)
        np.testing.assert_array_equal(pd, rd)
        # the tree layout: dst in ascending runs of length <= fanout
        live = pd[pd >= 0]
        assert np.all(np.diff(live) >= 0)


def test_gather_degree_scatter_match_jax():
    rng = np.random.default_rng(1)
    n, e, d = 40, 300, 6
    x = rng.standard_normal((n, d)).astype(np.float32)
    msgs = rng.standard_normal((e, d)).astype(np.float32)
    src = rng.integers(-1, n, e).astype(np.int32)
    dst = rng.integers(-1, n, e).astype(np.int32)
    _close(port_layers.gather(_t(x), _t(src)),
           ref_layers.gather(jnp.asarray(x), jnp.asarray(src)))
    _close(port_layers.degree(_t(dst), n),
           ref_layers.degree(jnp.asarray(dst), n))
    for use_kernel in (False, True):
        got = port_layers.scatter_sum(_t(msgs), _t(dst), n,
                                      use_kernel=use_kernel)
        assert got.dtype == torch.float32
        _close(got, ref_layers.scatter_sum(jnp.asarray(msgs),
                                           jnp.asarray(dst), n,
                                           use_kernel=use_kernel))
    _close(port_layers.scatter_mean(_t(msgs), _t(dst), n),
           ref_layers.scatter_mean(jnp.asarray(msgs), jnp.asarray(dst), n))


def test_gather_clamps_ids_at_or_above_n_as_the_reference_does():
    """JAX's gather clamps an id at or above N to the last row; -1 (and
    any negative id) is zero-filled."""
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([0, -1, 3, 4, 7], np.int32)
    got = port_layers.gather(_t(x), _t(idx))
    want = np.asarray(ref_layers.gather(jnp.asarray(x), jnp.asarray(idx)))
    np.testing.assert_array_equal(want, x[[0, 0, 3, 3, 3]] * [[1], [0], [1],
                                                            [1], [1]])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(4))
def test_gather_matches_the_reference_on_ids_past_n(seed):
    rng = np.random.default_rng(seed)
    n, e, d = int(rng.integers(1, 30)), 200, 5
    x = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(-1, n + 3, e).astype(np.int32)
    np.testing.assert_array_equal(
        port_layers.gather(_t(x), _t(idx)).numpy(),
        np.asarray(ref_layers.gather(jnp.asarray(x), jnp.asarray(idx))))


def test_scatter_sum_keeps_the_reference_result_dtype():
    msgs = torch.ones(5, 3, dtype=torch.bfloat16)
    dst = torch.tensor([0, 1, 1, -1, 2])
    assert port_layers.scatter_sum(msgs, dst, 3).dtype == torch.bfloat16
    assert port_layers.scatter_sum(msgs, dst, 3,
                                   use_kernel=True).dtype == torch.float32


def _forward_pair(cfg_ref, block_ref, seed=0):
    """Logits of both packages on one block with the JAX weights."""
    src, dst, n = ref_block_to_edges(block_ref)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, cfg_ref.d_in)).astype(np.float32)
    x[np.concatenate(block_ref.layer_nodes) < 0] = 0
    params = ref_gcn.init_params(cfg_ref, jax.random.key(seed))
    want = ref_gcn.forward(params, {"x": jnp.asarray(x),
                                    "edge_src": jnp.asarray(src.astype(np.int32)),
                                    "edge_dst": jnp.asarray(dst.astype(np.int32))},
                           cfg_ref)
    cfg = port_configs.get_arch("gcn-cora").make_config()
    cfg = dataclasses.replace(
        cfg, **{f.name: getattr(cfg_ref, f.name)
                for f in dataclasses.fields(cfg) if f.name != "dtype"})
    pparams = gcn_params_from_numpy({k: np.asarray(v)
                                     for k, v in params.items()}, "cpu")
    batch = {"x": _t(x), "edge_src": _t(src.astype(np.int32)),
             "edge_dst": _t(dst.astype(np.int32))}
    with torch.inference_mode():
        got = port_gcn.forward(pparams, batch, cfg)
    return got, want, pparams, batch, cfg, params


@pytest.mark.parametrize("variant", ["reduced", "full", "mean",
                                     "transform_first"])
def test_gcn_forward_matches_jax(graph, variant):
    spec = ref_get_arch("gcn-cora")
    cfg_ref = spec.make_reduced() if variant == "reduced" else \
        spec.make_config()
    if variant == "mean":
        cfg_ref = dataclasses.replace(cfg_ref, norm="mean")
    if variant == "transform_first":
        cfg_ref = dataclasses.replace(cfg_ref, transform_first=True)
    # ~120 nodes: 4 seeds, fanouts (5, 5)
    rb, pb = next(_blocks(graph, (5, 5), 4, n=1))
    assert pb.num_nodes() == rb.num_nodes() == 124
    got, want, *_ = _forward_pair(cfg_ref, rb)
    assert tuple(got.shape) == (124, cfg_ref.n_classes)
    _close(got, want)


def test_gcn_loss_matches_jax(graph):
    cfg_ref = ref_get_arch("gcn-cora").make_reduced()
    rb = next(_blocks(graph, (3, 2), 8, n=1))[0]
    got, _, pparams, batch, cfg, params = _forward_pair(cfg_ref, rb, seed=2)
    n = batch["x"].shape[0]
    rng = np.random.default_rng(5)
    labels = rng.integers(0, cfg.n_classes, n)
    mask = rng.random(n) < 0.5
    want = ref_gcn.loss_fn(params, {
        "x": jnp.asarray(batch["x"].numpy()),
        "edge_src": jnp.asarray(batch["edge_src"].numpy()),
        "edge_dst": jnp.asarray(batch["edge_dst"].numpy()),
        "labels": jnp.asarray(labels), "label_mask": jnp.asarray(mask)},
        cfg_ref)
    batch.update(labels=_t(labels), label_mask=_t(mask))
    loss = port_gcn.loss_fn(pparams, batch, cfg)
    np.testing.assert_allclose(float(loss), float(want), rtol=RTOL, atol=ATOL)


def test_configs_and_params_mirror_the_reference():
    spec = port_configs.get_arch("gcn-cora")
    ref_spec = ref_get_arch("gcn-cora")
    assert (spec.arch_id, spec.family, spec.citation) == \
        (ref_spec.arch_id, ref_spec.family, ref_spec.citation)
    assert port_configs.ARCH_IDS == ["qwen2-moe-a2.7b", "dbrx-132b",
                                     "smollm-360m", "qwen2-1.5b",
                                     "stablelm-1.6b", "dimenet",
                                     "meshgraphnet", "gcn-cora", "pna"]
    for make in ("make_config", "make_reduced"):
        a, b = getattr(spec, make)(), getattr(ref_spec, make)()
        for f in dataclasses.fields(b):
            if f.name != "dtype":
                assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert a.dtype == torch.float32
        gen = torch.Generator().manual_seed(0)
        p = port_gcn.init_params(a, gen)
        r = ref_gcn.init_params(b, jax.random.key(0))
        assert sorted(p) == sorted(r) == ["b0", "b1", "w0", "w1"]
        for k in r:
            assert tuple(p[k].shape) == r[k].shape and p[k].dtype == torch.float32
    assert set(spec.shapes) == set(ref_spec.shapes)
    with pytest.raises(KeyError, match="not ported yet"):
        port_configs.get_arch("din")
    assert port_configs.NOT_PORTED == ("din",)
    ref_ids = __import__("repro.configs", fromlist=["x"]).ARCH_IDS
    assert port_configs.ARCH_IDS == [a for a in ref_ids if a != "din"]
    for arch in ("qwen2-moe-a2.7b", "dbrx-132b"):
        assert port_configs.get_arch(arch).family == "lm"
    with pytest.raises(KeyError, match="unknown arch"):
        port_configs.get_arch("no-such-arch")
    from repro_torch.models.gnn import dimenet, meshgraphnet, pna
    assert _GNN_MODULES == {"gcn-cora": port_gcn, "pna": pna,
                            "dimenet": dimenet, "meshgraphnet": meshgraphnet}
    assert port_configs.all_cells() == [
        c for c in __import__("repro.configs", fromlist=["x"]).all_cells()
        if c[0] in port_configs.ARCH_IDS]


def test_dense_init_is_a_truncated_fan_in_normal():
    from repro_torch.models.common import dense_init
    w = dense_init(torch.Generator().manual_seed(1), (1433, 64))
    assert w.dtype == torch.float32
    assert float(w.abs().max()) <= 2 * 1433 ** -0.5 + 1e-7
    assert abs(float(w.std()) * 1433 ** 0.5 - 0.88) < 0.02   # trunc at 2 sd
    a = dense_init(torch.Generator().manual_seed(1), (8, 4))
    b = dense_init(torch.Generator().manual_seed(1), (8, 4))
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch,fields", [
    ("meshgraphnet", "edge_attr, targets"),
    ("dimenet", "pos, triplet_kj, triplet_ji, graph_id, n_graphs, targets")])
@pytest.mark.parametrize("path", ["serving", "--full-graph", "--sampled"])
def test_paths_without_the_fields_refuse_meshgraphnet_and_dimenet(
        tmp_path, arch, fields, path):
    """Serving, ``--full-graph`` and ``--sampled`` build none of these
    models' fields: the CLI exits at once saying which (the JAX package
    runs on into a ``KeyError`` inside ``forward``), before any asset is
    written."""
    from repro_torch.launch import serve, train
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--workdir",
            str(tmp_path)]
    msg = f"{arch}: {path} builds no {fields} batch fields"
    with pytest.raises(SystemExit, match=msg):
        if path == "serving":
            serve.main(argv + ["--requests", "1"])
        else:
            train.main(argv + [path, "--steps", "1"])
    assert not any(tmp_path.iterdir())
