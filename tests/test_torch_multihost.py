"""Multi-host streamed loading: the port's ``repro_torch.data.multihost``
simulator (``device="cpu"``, so each host's decode takes K1's plain
version) against the JAX package's on the same file, and the full
storage -> PG-Fuse -> packed CompBin -> decode -> train loop.

Integers (shards, plans, ranges, every counter of ``StreamStats``):
tolerance ZERO, per host and in aggregate.  Training: gcn-cora on two
simulated hosts with the JAX package's weights carried over, 15 AdamW
steps, each step's loss within rtol 1e-5 of the JAX package's (f32 on
both sides; sums in another order)."""

import _torch_env  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import assert_csr_equal
from repro.core import paragrapher as ref_paragrapher
from repro.data import assemble_csr as ref_assemble_csr
from repro.data.multihost import all_shards as ref_all_shards
from repro.data.multihost import resplit_shares as ref_resplit_shares
from repro.data.multihost import simulate_hosts as ref_simulate_hosts
from repro.graph import rmat
from repro.launch.data_gnn import streamed_graph_batch as ref_streamed_batch
from repro.models.gnn import gcn as ref_gcn
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro_torch.convert import gcn_params_from_numpy, stats_ints
from repro_torch.core import compbin, paragrapher, policy
from repro_torch.data.graph_stream import assemble_csr, stream_partitions
from repro_torch.data.multihost import (aggregate_stats, all_shards,
                                        resplit_shares, simulate_hosts)
from repro_torch.launch.data_gnn import streamed_graph_batch
from repro_torch.models.gnn import gcn
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

OPEN_KW = dict(use_pgfuse=True, pgfuse_block_size=1 << 14,
               pgfuse_readahead=2)
CPU = "cpu"

#: storage-stage counters depend on how reader threads interleave with
#: the block cache; hits + misses (block acquisitions) stay exact
_STORAGE = {"underlying_reads", "underlying_bytes", "cache_hits",
            "cache_misses", "readahead_blocks"}


def _counters(stats) -> dict:
    d = {k: v for k, v in stats_ints(stats).items() if k not in _STORAGE}
    d["acquisitions"] = stats.cache_hits + stats.cache_misses
    return d


@pytest.fixture(scope="module")
def graph_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh")
    csr = rmat(9, 6, seed=3)
    p = str(d / "g.cbin")
    ref_paragrapher.save_graph(p, csr, format="compbin")
    return p, csr


# ---------------------------------------------------------------------------
# the simulator: coverage, determinism, stats, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_hosts_reassemble_the_graph_as_the_reference_does(graph_file, hosts):
    path, csr = graph_file
    got = simulate_hosts(path, hosts, CPU, open_kwargs=OPEN_KW, n_parts=8)
    want = ref_simulate_hosts(path, hosts, open_kwargs=OPEN_KW, n_parts=8)
    assert [r.process_index for r in got] == list(range(hosts))
    for g, w in zip(got, want):
        assert g.plan == w.plan
        assert tuple(g.host_range) == tuple(w.host_range)
        assert g.n_vertices == w.n_vertices == csr.n_vertices
        assert _counters(g.stats) == _counters(w.stats)
        assert all(s.neighbors.device == torch.device(CPU) for s in g.shards)
    cursor = 0
    for r in got:
        if not r.plan:
            continue
        assert r.host_range[0] == cursor
        cursor = r.host_range[1]
    assert cursor == csr.n_vertices
    # the union of every host's shards is the whole graph, byte-exact
    assert_csr_equal(assemble_csr(all_shards(got)), csr)
    assert_csr_equal(assemble_csr(all_shards(got)),
                     ref_assemble_csr(ref_all_shards(want)))
    assert _counters(aggregate_stats(got)) == \
        _counters(aggregate_stats(want))


def test_multihost_zero_host_decode_for_compbin(graph_file):
    path, csr = graph_file
    before = compbin.host_decoded_bytes()
    results = simulate_hosts(path, 2, CPU, open_kwargs=OPEN_KW, n_parts=8)
    assert compbin.host_decoded_bytes() - before == 0
    for r in results:
        assert r.stats.decode_mode == "device"
        assert r.stats.host_decode_bytes == 0


def test_per_host_stats_sum_to_single_host_totals(graph_file):
    path, csr = graph_file
    results = simulate_hosts(path, 2, CPU, open_kwargs=OPEN_KW, n_parts=8)
    single = simulate_hosts(path, 1, CPU, open_kwargs=OPEN_KW, n_parts=8)[0]
    agg = aggregate_stats(results)
    one = single.stats
    for r in results:  # reported per process, each with real traffic
        assert r.stats.partitions > 0
        assert r.stats.bytes_h2d > 0
        assert r.stats.cache_hits + r.stats.cache_misses > 0
    assert agg.partitions == one.partitions > 1
    assert agg.vertices == one.vertices == csr.n_vertices
    assert agg.edges == one.edges == csr.n_edges
    assert agg.bytes_h2d == one.bytes_h2d
    assert agg.host_decode_bytes == one.host_decode_bytes == 0
    assert (agg.cache_hits + agg.cache_misses
            == one.cache_hits + one.cache_misses)


def test_host_decode_stats_are_per_stream_under_concurrency(graph_file):
    path, csr = graph_file
    plan = policy.StreamDecodePlan("host", "test: force host decode")
    results = simulate_hosts(path, 2, CPU, open_kwargs=OPEN_KW, n_parts=8,
                             decode_plan=plan)
    single = simulate_hosts(path, 1, CPU, open_kwargs=OPEN_KW, n_parts=8,
                            decode_plan=plan)[0]
    with paragrapher.open_graph(path) as g:
        b = g.bytes_per_id
    for r in results:
        assert r.stats.host_decode_bytes == r.stats.edges * b
    agg = aggregate_stats(results)
    assert agg.host_decode_bytes == single.stats.host_decode_bytes \
        == csr.n_edges * b


def test_sequential_equals_concurrent_simulation(graph_file):
    path, csr = graph_file
    conc = simulate_hosts(path, 2, CPU, open_kwargs=OPEN_KW, n_parts=8)
    seq = simulate_hosts(path, 2, CPU, open_kwargs=OPEN_KW, n_parts=8,
                         concurrent=False)
    for a, b in zip(conc, seq):
        assert a.plan == b.plan
        assert a.host_range == b.host_range
        assert assemble_csr(a.shards) == assemble_csr(b.shards)
        assert _counters(a.stats) == _counters(b.stats)


def test_more_hosts_than_partitions(graph_file):
    path, csr = graph_file
    results = simulate_hosts(path, 5, CPU, open_kwargs=OPEN_KW, n_parts=3)
    assert_csr_equal(assemble_csr(all_shards(results)), csr)
    empty = [r for r in results if not r.plan]
    assert empty
    for r in empty:  # hosts with nothing to stream report quietly
        assert r.shards == []
        assert r.stats.partitions == 0
        assert r.stats.decode_edges_per_s == 0.0


def test_stream_process_args_validated(graph_file):
    path, _ = graph_file
    with paragrapher.open_graph(path) as g:
        with pytest.raises(ValueError):
            stream_partitions(g, CPU, process_index=2, process_count=2)
    with pytest.raises(ValueError):
        simulate_hosts(path, 0, CPU)


def test_default_device_raises_without_a_gpu(graph_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_hosts(graph_file[0], 2, open_kwargs=OPEN_KW)


def test_resplit_shares_equal_the_reference(graph_file):
    path, _ = graph_file
    got = simulate_hosts(path, 3, CPU, open_kwargs=OPEN_KW, n_parts=9)
    want = ref_simulate_hosts(path, 3, open_kwargs=OPEN_KW, n_parts=9)
    # the shares come from measured wall times: give both the same ones
    for g, w, t in zip(got, want, (1.0, 2.0, 0.5)):
        g.stats.wall_s = w.stats.wall_s = t
    np.testing.assert_array_equal(np.asarray(resplit_shares(got)),
                                  np.asarray(ref_resplit_shares(want)))


def test_feature_and_label_streams_match_the_reference(tmp_path):
    """The ``--full-graph`` triplet on two hosts with the feature-aligned
    cuts: the port's full-graph batch equals the JAX package's tensor for
    tensor (features and labels off storage, ids as int32)."""
    from repro.launch.data_gnn import ensure_gnn_assets

    gp, fp, lp = ensure_gnn_assets(str(tmp_path), 16, 4, scale=9,
                                   edge_factor=6)
    with paragrapher.open_graph(gp) as g:
        align = policy.choose_feature_align(1 << 16, 16 * 4, g.n_vertices, 2)
    kw = dict(open_kwargs=OPEN_KW, feature_path=fp, label_path=lp,
              align=align)
    got = simulate_hosts(gp, 2, CPU, **kw)
    want = ref_simulate_hosts(gp, 2, **kw)
    for g, w in zip(got, want):
        assert _counters(g.stats) == _counters(w.stats)
    cfg = gcn.GCNConfig(d_in=16, n_classes=4)
    pb = streamed_graph_batch("gcn-cora", cfg, all_shards(got),
                              np.random.default_rng(0), n_classes=4,
                              n_vertices=got[0].n_vertices)
    rb = ref_streamed_batch("gcn-cora", ref_gcn.GCNConfig(d_in=16,
                                                          n_classes=4),
                            ref_all_shards(want), np.random.default_rng(0),
                            n_classes=4, n_vertices=want[0].n_vertices)
    assert set(pb) == set(rb)
    for k in pb:
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(rb[k]), k)
    assert pb["edge_src"].dtype == pb["edge_dst"].dtype == torch.int32
    assert pb["labels"].dtype == torch.int32
    assert pb["label_mask"].dtype == torch.bool


# ---------------------------------------------------------------------------
# end to end: gcn-cora full-graph training from CompBin on two hosts
# ---------------------------------------------------------------------------

def test_e2e_gcn_cora_full_graph_train_matches_jax_two_hosts(graph_file):
    path, csr = graph_file
    results = simulate_hosts(path, 2, CPU, open_kwargs=OPEN_KW, n_parts=8)
    single = simulate_hosts(path, 1, CPU, open_kwargs=OPEN_KW, n_parts=8)[0]
    ref_results = ref_simulate_hosts(path, 2, open_kwargs=OPEN_KW, n_parts=8)
    agg = aggregate_stats(results)
    assert agg.bytes_h2d == single.stats.bytes_h2d
    assert agg.edges == single.stats.edges == csr.n_edges

    cfg = gcn.GCNConfig(n_layers=2, d_hidden=16, d_in=16, n_classes=7)
    rcfg = ref_gcn.GCNConfig(n_layers=2, d_hidden=16, d_in=16, n_classes=7)
    batch = streamed_graph_batch("gcn-cora", cfg, all_shards(results),
                                 np.random.default_rng(0),
                                 n_classes=cfg.n_classes,
                                 n_vertices=results[0].n_vertices)
    rbatch = ref_streamed_batch("gcn-cora", rcfg, ref_all_shards(ref_results),
                                np.random.default_rng(0),
                                n_classes=rcfg.n_classes,
                                n_vertices=ref_results[0].n_vertices)
    assert int(batch["x"].shape[0]) == csr.n_vertices
    assert int(batch["edge_src"].shape[0]) == csr.n_edges
    for k in ("x", "edge_src", "edge_dst", "labels", "label_mask"):
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(rbatch[k]))

    rparams = ref_gcn.init_params(rcfg, jax.random.key(0))
    params = gcn_params_from_numpy(
        {k: np.asarray(v) for k, v in rparams.items()}, device=CPU)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=15)
    ropt_cfg, opt_cfg = RefAdamWConfig(**kw), AdamWConfig(**kw)
    ropt, opt = ref_adamw_init(rparams, ropt_cfg), adamw_init(params, opt_cfg)

    @jax.jit
    def ref_step(params, opt, batch):
        loss, grads = jax.value_and_grad(ref_gcn.loss_fn)(params, batch, rcfg)
        params, opt, _ = ref_adamw_update(params, grads, opt, ropt_cfg)
        return params, opt, loss

    losses, ref_losses = [], []
    for _ in range(15):
        rparams, ropt, rloss = ref_step(rparams, ropt, rbatch)
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = gcn.loss_fn(p, batch, cfg)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        params, opt, _ = adamw_update(params, grads, opt, opt_cfg)
        losses.append(float(loss.detach()))
        ref_losses.append(float(rloss))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses  # full-batch training converges
    for k in params:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(rparams[k]),
                                   rtol=1e-4, atol=1e-6)


def test_e2e_missing_host_shards_fail_loudly(graph_file):
    """Full-graph training on HALF the hosts' shards must raise, not
    silently train on a truncated graph."""
    path, csr = graph_file
    results = simulate_hosts(path, 2, CPU, open_kwargs=OPEN_KW, n_parts=8)
    cfg = gcn.GCNConfig(n_layers=2, d_hidden=16, d_in=16, n_classes=7)
    with pytest.raises(ValueError, match="every host"):
        # interior/leading gap: host 0's shards missing
        streamed_graph_batch("gcn-cora", cfg, results[1].shards,
                             np.random.default_rng(0))
    with pytest.raises(ValueError, match="every host"):
        # trailing gap: host 1's shards missing — only detectable against
        # the graph's true vertex count
        streamed_graph_batch("gcn-cora", cfg, results[0].shards,
                             np.random.default_rng(0),
                             n_vertices=results[0].n_vertices)


def test_mixed_feature_shards_fail_loudly(graph_file):
    from repro_torch.launch.data_gnn import (shards_to_features,
                                             shards_to_labels)
    path, _ = graph_file
    shards = all_shards(simulate_hosts(path, 2, CPU, open_kwargs=OPEN_KW,
                                       n_parts=4))
    shards[0].x = torch.zeros(shards[0].n_vertices, 3)
    with pytest.raises(ValueError, match="every host"):
        shards_to_features(shards)
    shards[0].y = torch.zeros(shards[0].n_vertices, 2, dtype=torch.uint8)
    with pytest.raises(ValueError, match="every host"):
        shards_to_labels(shards)
    assert shards_to_features(shards[1:]) is None
