"""GCN inference serving, end to end on the CPU: the port's
``make_gnn_server`` against the JAX package's on the same assets,
weights and request stream (logits rtol 1e-5 / atol 1e-4, integer
engine counters equal), and against the port's own in-memory path (bit
for bit: same code, same device)."""

import _torch_env  # noqa: F401  (first: one torch thread)
import json
import pathlib
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch import data_gnn as ref_data_gnn
from repro.launch.serve import make_gnn_server as ref_make_gnn_server
from repro.models.gnn import gcn as ref_gcn
from repro_torch.configs import get_arch
from repro_torch.convert import gcn_params_from_numpy, stats_ints
from repro_torch.core import paragrapher
from repro_torch.graph import NeighborSampler, synthesize_node_features
from repro_torch.launch import data_gnn
from repro_torch.launch import serve as port_serve
from repro_torch.models.gnn import gcn
from repro_torch.obs import Tracer

RTOL, ATOL = 1e-5, 1e-4


def _requests(n, n_req=2, batch=12, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_req):
        hot = rng.integers(0, max(1, n // 16), batch)
        cold = rng.integers(0, n, batch)
        out.append(np.where(rng.random(batch) < 0.5, hot, cold))
    return out


def test_assets_are_byte_equal(tmp_path):
    kw = dict(scale=8, edge_factor=4, block_size=1 << 12)
    rp = ref_data_gnn.ensure_gnn_assets(str(tmp_path / "ref"), 16, 4, **kw)
    pp = data_gnn.ensure_gnn_assets(str(tmp_path / "port"), 16, 4, **kw)
    for a, b in zip(rp, pp):
        assert pathlib.Path(a).name == pathlib.Path(b).name
        assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()
    # idempotent: a second call rewrites nothing
    mtimes = [pathlib.Path(p).stat().st_mtime_ns for p in pp]
    assert data_gnn.ensure_gnn_assets(str(tmp_path / "port"), 16, 4,
                                      **kw) == pp
    assert [pathlib.Path(p).stat().st_mtime_ns for p in pp] == mtimes


@pytest.mark.parametrize("decode", ["host", "device"])
def test_served_logits_match_the_jax_server(tmp_path, decode):
    cfg_ref = ref_get_arch("gcn-cora").make_reduced()
    cfg = get_arch("gcn-cora").make_reduced()
    jparams = ref_gcn.init_params(cfg_ref, jax.random.key(0))
    params = gcn_params_from_numpy({k: np.asarray(v)
                                    for k, v in jparams.items()}, "cpu")
    r_answer, r_engine, r_close = ref_make_gnn_server(
        "gcn-cora", cfg_ref, str(tmp_path / "ref"), fanouts=(3, 2), seed=11,
        decode=decode)
    p_answer, p_engine, p_close = port_serve.make_gnn_server(
        "gcn-cora", cfg, str(tmp_path / "port"), fanouts=(3, 2), seed=11,
        decode=decode, device="cpu", params=params)
    try:
        for seeds in _requests(r_engine.n_vertices):
            want = r_answer(seeds)
            got = p_answer(seeds)
            assert got.shape == want.shape == (12, cfg.n_classes)
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert stats_ints(p_engine.stats) == stats_ints(r_engine.stats)
        if decode == "device":
            assert p_engine.stats.device_batches == p_engine.stats.batches
    finally:
        r_close()
        p_close()


@pytest.mark.parametrize("decode", ["host", "device"])
def test_served_logits_equal_the_in_memory_path(tmp_path, decode):
    cfg = get_arch("gcn-cora").make_reduced()
    workdir = str(tmp_path)
    answer, engine, close = port_serve.make_gnn_server(
        "gcn-cora", cfg, workdir, fanouts=(3, 2), seed=11, decode=decode,
        device="cpu")
    try:
        gp, _, _ = data_gnn.ensure_gnn_assets(workdir, cfg.d_in,
                                              cfg.n_classes)
        with paragrapher.open_graph(gp) as g:
            csr = g.read_full()
        x = synthesize_node_features(csr.n_vertices, cfg.d_in, seed=0)
        sampler = NeighborSampler(csr, (3, 2), seed=11)
        params = gcn.init_params(cfg, torch.Generator().manual_seed(0))
        for seeds in _requests(csr.n_vertices):
            got = answer(seeds)
            block = sampler.sample(seeds)
            src, dst, n = data_gnn.block_to_edges(block)
            nodes = np.concatenate(block.layer_nodes)
            valid = np.concatenate(block.layer_valid)
            xr = np.zeros((n, cfg.d_in), np.float32)
            xr[valid] = x[nodes[valid]]
            with torch.inference_mode():
                want = gcn.forward(params, {
                    "x": torch.from_numpy(xr),
                    "edge_src": torch.from_numpy(src.astype(np.int32)),
                    "edge_dst": torch.from_numpy(dst.astype(np.int32)),
                }, cfg)[:len(seeds)].numpy()
            assert np.array_equal(got, want), decode
    finally:
        close()


def test_store_batch_carries_labels_and_lands_on_the_device(tmp_path):
    cfg = get_arch("gcn-cora").make_reduced()
    gp, fp, lp = data_gnn.ensure_gnn_assets(str(tmp_path), cfg.d_in,
                                            cfg.n_classes, scale=8)
    from repro_torch.core import featstore
    with paragrapher.open_graph(gp) as g, \
            featstore.open_featstore(fp) as feats, \
            featstore.open_featstore(lp) as labels:
        block = NeighborSampler(g.read_full(), (3, 2), seed=1).sample(
            np.arange(6))
        batch = data_gnn.sampled_store_batch("gcn-cora", cfg, block, feats,
                                             labels, device="cpu")
        fam = labels.read_rows(0, 6)
    n = block.num_nodes()
    assert batch["x"].shape == (n, cfg.d_in) and batch["x"].dtype == torch.float32
    assert batch["edge_src"].dtype == batch["edge_dst"].dtype == torch.int32
    np.testing.assert_array_equal(batch["labels"][:6].numpy(), fam[:, 0])
    np.testing.assert_array_equal(batch["label_mask"][:6].numpy(),
                                  fam[:, 1].astype(bool))
    assert not batch["label_mask"][6:].any()
    assert all(t.device.type == "cpu" for t in batch.values())


def test_request_spans_split_the_time_by_tier(tmp_path):
    cfg = get_arch("gcn-cora").make_reduced()
    tracer = Tracer()
    answer, engine, close = port_serve.make_gnn_server(
        "gcn-cora", cfg, str(tmp_path), fanouts=(3, 2), decode="host",
        device="cpu", tracer=tracer)
    try:
        answer(np.arange(10))
    finally:
        close()
    (root,) = tracer.drain()
    assert root.name == "gnn.request"
    tiers = {s.tier for s in root.iter_spans()}
    assert {"request", "sample", "gather", "features", "h2d",
            "compute"} <= tiers


def test_unported_options_raise(tmp_path, monkeypatch):
    """The hot-set option is ported: ``hotset_bytes`` serves (hub runs
    answered from the tier, logits equal to the server without it), and
    on a machine without a GPU the default device raises instead of
    serving from host memory."""
    cfg = get_arch("gcn-cora").make_reduced()
    seeds = np.arange(0, 64, 3)
    logits = {}
    for hot in (None, 1 << 20):
        answer, engine, close = port_serve.make_gnn_server(
            "gcn-cora", cfg, str(tmp_path), hotset_bytes=hot, decode="host",
            device="cpu")
        try:
            logits[hot] = [answer(seeds), answer(seeds)]
            if hot:
                assert engine.hotset.stats.hits > 0
                assert engine.hotset.stats.conserved
        finally:
            close()
    for a, b in zip(logits[None], logits[1 << 20]):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.make_gnn_server("gcn-cora", cfg, str(tmp_path),
                                   hotset_bytes=1 << 20)


def test_cli_serves_and_writes_metrics(tmp_path, caplog):
    out = tmp_path / "m.json"
    port_serve.main(["--arch", "gcn-cora", "--reduced", "--device", "cpu",
                     "--requests", "3", "--batch", "4",
                     "--workdir", str(tmp_path / "w"),
                     "--metrics-json", str(out), "--trace-sample", "2"])
    metrics = json.loads(out.read_text())["metrics"]
    assert metrics["query.batches"] > 0
    assert metrics["obs.sampled_traces"] == 2
    for argv, msg in ((["--arch", "smollm-360m", "--traversal"], "gnn arch"),
                      (["--arch", "qwen2-moe-a2.7b", "--traversal"],
                       "gnn arch"),
                      (["--arch", "din", "--traversal"], "gnn arch")):
        with pytest.raises(SystemExit, match=msg):
            port_serve.main(argv + ["--device", "cpu",
                                    "--workdir", str(tmp_path / "w")])


def test_collect_service_metrics_folds_every_surface(tmp_path):
    cfg = get_arch("gcn-cora").make_reduced()
    answer, engine, close = port_serve.make_gnn_server(
        "gcn-cora", cfg, str(tmp_path), decode="host", device="cpu")
    try:
        answer(np.arange(8))
        service = types.SimpleNamespace(
            engine=engine, as_dict=lambda: {
                "traversal": {"completed": 1},
                "query": engine.stats.as_dict()})
        reg = port_serve.collect_service_metrics(service)
    finally:
        close()
    assert reg.get("query.batches") == engine.stats.batches > 0
    assert reg.get("traversal.completed") == 1
    assert reg.get("pgfuse.cache_misses") > 0
