"""The streaming loader: the same file through the JAX package's loader
and the port's (``device="cpu"``, so the decode takes the kernel's plain
version).  Assembled CSR and integer counters: tolerance ZERO."""

import time

import numpy as np
import pytest
import torch

from _torch_pair import assert_csr_equal, port, ref, write_pair
from repro.data import graph_stream as ref_stream
from repro_torch.convert import shard_to_numpy, stats_ints
from repro_torch.core.featstore import read_featstore
from repro_torch.data import graph_stream as port_stream

#: storage-stage deltas depend on how reader threads interleave with the
#: block cache; the rest of the integer counters are exact
_STORAGE = {"underlying_reads", "underlying_bytes", "cache_hits",
            "cache_misses", "readahead_blocks"}


def _counters(stats):
    return {k: v for k, v in stats_ints(stats).items() if k not in _STORAGE}


@pytest.fixture(scope="module")
def graph():
    return ref.graph.rmat(11, 8, seed=5)


def _run_ref(path, **kw):
    with ref.paragrapher.open_graph(path, use_pgfuse=True,
                                    pgfuse_block_size=1 << 16,
                                    pgfuse_readahead=2) as g:
        with ref_stream.stream_partitions(g, None, **kw) as stream:
            shards = list(stream)
        return ref_stream.assemble_csr(shards), stream.stats, stream.plan


def _run_port(path, **kw):
    with port.paragrapher.open_graph(path, use_pgfuse=True,
                                     pgfuse_block_size=1 << 16,
                                     pgfuse_readahead=2) as g:
        with port_stream.stream_partitions(g, "cpu", **kw) as stream:
            shards = list(stream)
        return port_stream.assemble_csr(shards), stream.stats, stream.plan, \
            shards


@pytest.mark.parametrize("fmt", ["compbin", "logcsr"])
@pytest.mark.parametrize("n_parts", [None, 1, 5])
def test_packed_codecs_stream_identically(graph, fmt, n_parts, tmp_path):
    path = write_pair(tmp_path, graph.offsets, graph.neighbors, fmt)
    csr_r, st_r, plan_r = _run_ref(path, n_parts=n_parts)
    csr_p, st_p, plan_p, shards = _run_port(path, n_parts=n_parts)
    assert plan_p == plan_r
    assert_csr_equal(csr_p, csr_r)
    assert_csr_equal(csr_p, graph)
    assert _counters(st_p) == _counters(st_r)
    assert st_p.decode_mode == st_r.decode_mode == "device"
    assert st_p.host_decode_bytes == 0          # b <= 4: nothing on host
    assert st_p.bytes_h2d == st_r.bytes_h2d > 0
    assert (st_p.partitions, st_p.vertices, st_p.edges) == \
        (len(plan_p), graph.n_vertices, graph.n_edges)
    for s in shards:
        assert s.neighbors.dtype == torch.int32
        assert s.offsets.dtype == torch.int64
        assert s.neighbors.device.type == s.offsets.device.type == "cpu"
        v0, v1, offs, nbrs = shard_to_numpy(s)
        assert (v0, v1) == (s.v0, s.v1) and offs[0] == 0
        assert offs.shape == (s.n_vertices + 1,) and nbrs.shape == (s.n_edges,)
        assert s.x is None and s.y is None      # no store attached


def test_webgraph_host_arm_streams_identically(graph, tmp_path):
    path = write_pair(tmp_path, graph.offsets, graph.neighbors, "webgraph")
    csr_r, st_r, _ = _run_ref(path)
    csr_p, st_p, _, _ = _run_port(path)
    assert_csr_equal(csr_p, csr_r)
    assert_csr_equal(csr_p, graph)
    assert _counters(st_p) == _counters(st_r)
    assert st_p.decode_mode == st_r.decode_mode == "host"
    assert st_p.host_decode_bytes == st_r.host_decode_bytes > 0


def test_forced_host_decode_plan_streams_identically(graph, tmp_path):
    path = write_pair(tmp_path, graph.offsets, graph.neighbors, "compbin")
    out = {}
    for side, run in ((ref, _run_ref), (port, _run_port)):
        plan = side.policy.StreamDecodePlan("host", "forced by the test")
        res = run(path, decode_plan=plan)
        out[side.name] = (res[0], res[1])
    assert_csr_equal(out["port"][0], out["ref"][0])
    assert_csr_equal(out["port"][0], graph)
    assert _counters(out["port"][1]) == _counters(out["ref"][1])
    b = port.compbin.bytes_per_vertex(graph.n_vertices)
    assert out["port"][1].host_decode_bytes == graph.n_edges * b


def test_granule_and_multi_process_slices_match(graph, tmp_path):
    path = write_pair(tmp_path, graph.offsets, graph.neighbors, "compbin")
    for idx in range(2):
        kw = dict(granule=1 << 11, process_index=idx, process_count=2)
        csr_r, st_r, plan_r = _run_ref(path, **kw)
        csr_p, st_p, plan_p, _ = _run_port(path, **kw)
        assert plan_p == plan_r
        assert_csr_equal(csr_p, csr_r)
        assert _counters(st_p) == _counters(st_r)


def test_merge_stats_equal(graph, tmp_path):
    path = write_pair(tmp_path, graph.offsets, graph.neighbors, "compbin")
    parts_r = [_run_ref(path, process_index=i, process_count=2)[1]
               for i in range(2)]
    parts_p = [_run_port(path, process_index=i, process_count=2)[1]
               for i in range(2)]
    m_r, m_p = ref_stream.merge_stats(parts_r), port_stream.merge_stats(parts_p)
    assert _counters(m_p) == _counters(m_r)
    assert m_p.edges == graph.n_edges and m_p.decode_mode == "device"
    assert set(m_p.as_dict()) == set(m_r.as_dict())


def test_early_close_exits_promptly(graph, tmp_path):
    path = write_pair(tmp_path, graph.offsets, graph.neighbors, "compbin")
    with port.paragrapher.open_graph(path, use_pgfuse=True,
                                     pgfuse_block_size=1 << 14) as g:
        stream = port_stream.stream_partitions(g, "cpu", n_parts=32,
                                               n_buffers=1, readahead=1)
        first = next(stream)
        assert first.n_edges >= 0
        t0 = time.perf_counter()
        stream.close()
        assert time.perf_counter() - t0 < 5.0
        stream.close()                      # idempotent
        assert stream._prefetch._thread.is_alive() is False
        with pytest.raises(StopIteration):
            next(stream)


def test_unported_stages_raise_not_implemented(graph, tmp_path):
    """The feature and label stages are ported: what raises now is a
    store that does not fit the graph, or a missing one."""
    path = write_pair(tmp_path, graph.offsets, graph.neighbors, "compbin")
    short = str(tmp_path / "short.fst")
    port.graph.write_node_features(short, np.zeros((7, 3), np.float32))
    with port.paragrapher.open_graph(path) as g:
        for kw in ({"feature_path": short}, {"label_path": short}):
            with pytest.raises(ValueError, match="rows for a graph"):
                port_stream.stream_partitions(g, "cpu", **kw)
        for kw in ({"feature_path": str(tmp_path / "x.fst")},
                   {"label_path": str(tmp_path / "y.fst")}):
            with pytest.raises(FileNotFoundError):
                port_stream.stream_partitions(g, "cpu", **kw)
        with pytest.raises(ValueError):
            port_stream.stream_partitions(g, "cpu", process_index=2,
                                          process_count=2)


@pytest.mark.parametrize("n_parts", [None, 5])
def test_feature_and_label_stages_stream_identically(graph, n_parts,
                                                     tmp_path):
    path = write_pair(tmp_path, graph.offsets, graph.neighbors, "compbin")
    fp = ref.graph.featstore_for_graph(path, str(tmp_path / "x.fst"), 12,
                                       seed=2, data_align=1 << 12)
    lp = ref.graph.labelstore_for_graph(path, str(tmp_path / "y.lbl"), 5,
                                        seed=2, data_align=1 << 12)
    kw = dict(n_parts=n_parts, feature_path=fp, label_path=lp)
    csr_r, st_r, _ = _run_ref(path, **kw)
    csr_p, st_p, _, shards = _run_port(path, **kw)
    assert_csr_equal(csr_p, csr_r)
    assert _counters(st_p) == _counters(st_r)
    assert st_p.feature_rows == st_p.label_rows == graph.n_vertices
    assert st_p.feature_bytes == st_p.feature_bytes_h2d == \
        graph.n_vertices * 12 * 4
    assert (st_p.feature_cache_hits, st_p.feature_cache_misses) == \
        (st_r.feature_cache_hits, st_r.feature_cache_misses)
    x = port.graph.synthesize_node_features(graph.n_vertices, 12, seed=2)
    y = read_featstore(lp)
    for s in shards:
        assert s.x.dtype == torch.float32 and s.y.dtype == torch.uint8
        np.testing.assert_array_equal(s.x.numpy(), x[s.v0:s.v1])
        np.testing.assert_array_equal(s.y.numpy(), y[s.v0:s.v1])


def test_empty_graph_streams(tmp_path):
    offsets, neighbors = np.zeros(1, np.int64), np.zeros(0, np.int32)
    path = write_pair(tmp_path, offsets, neighbors, "compbin", "empty")
    csr_r, st_r, _ = _run_ref(path)
    csr_p, st_p, _, _ = _run_port(path)
    assert_csr_equal(csr_p, csr_r)
    assert _counters(st_p) == _counters(st_r)
