"""The query engine: the same file and the same seeded trace through the
JAX package's engine and the port's (``device="cpu"``).  Answers and
integer counters: tolerance ZERO."""

import numpy as np
import pytest

from _torch_pair import port, ref, write_pair
from repro.query import NeighborQueryEngine as RefEngine
from repro_torch.convert import stats_ints
from repro_torch.query import NeighborQueryEngine as PortEngine


@pytest.fixture(scope="module")
def graph():
    return ref.graph.rmat(11, 8, seed=2)


def _trace(n_vertices: int, seed: int, n_batches: int = 6):
    rng = np.random.default_rng(seed)
    sizes = [1, 7, 64, 300, 1024, 2000]
    return [rng.integers(0, n_vertices, sizes[i % len(sizes)])
            for i in range(n_batches)]


def _open(side, path):
    amode = side.policy.choose_access_mode("serve")
    return side.paragrapher.open_graph(
        path, use_pgfuse=True, pgfuse_block_size=1 << 14,
        pgfuse_readahead=amode.readahead, pgfuse_eviction=amode.eviction,
        pgfuse_max_resident_bytes=1 << 20)


def _expected(graph, vs):
    return [graph.neighbors[graph.offsets[v]:graph.offsets[v + 1]]
            .astype(np.int64) for v in vs]


def _assert_answers(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", ["compbin", "logcsr"])
@pytest.mark.parametrize("decode", ["host", "device", "auto"])
def test_same_trace_same_answers_same_counters(graph, fmt, decode, tmp_path):
    path = write_pair(tmp_path, graph.offsets, graph.neighbors, fmt)
    trace = _trace(graph.n_vertices, 17)
    with _open(ref, path) as gr, _open(port, path) as gp, \
            RefEngine(gr, decode=decode) as er, \
            PortEngine(gp, decode=decode, device="cpu") as ep:
        for vs in trace:
            ans_r, ans_p = er.neighbors_batch(vs), ep.neighbors_batch(vs)
            _assert_answers(ans_p, ans_r)
            _assert_answers(ans_p, _expected(graph, vs))
        offs_r, ids_r = er.neighbors_batch_ragged(trace[3])
        offs_p, ids_p = ep.neighbors_batch_ragged(trace[3])
        np.testing.assert_array_equal(offs_p, offs_r)
        np.testing.assert_array_equal(ids_p, ids_r)
        np.testing.assert_array_equal(ep.neighbors_of(5), er.neighbors_of(5))
        ints_r, ints_p = stats_ints(er.stats), stats_ints(ep.stats)
    assert ints_p == ints_r
    assert ints_p["batches"] == len(trace) + 2
    if decode == "host":
        assert ints_p["device_batches"] == 0 and ints_p["bytes_h2d"] == 0
    if decode == "device":
        assert ints_p["device_batches"] == ints_p["batches"]
        assert ints_p["bytes_h2d"] > 0
    if decode == "auto":
        assert 0 < ints_p["device_batches"] < ints_p["batches"]


def test_async_submit_path_matches(graph, tmp_path):
    path = write_pair(tmp_path, graph.offsets, graph.neighbors, "compbin")
    reqs = _trace(graph.n_vertices, 23, n_batches=5)
    out = {}
    for side, engine_cls, kw in ((ref, RefEngine, {}),
                                 (port, PortEngine, {"device": "cpu"})):
        with _open(side, path) as g, \
                engine_cls(g, decode="device", window_s=0.05, **kw) as eng:
            futs = [eng.submit(vs) for vs in reqs]
            out[side.name] = [f.result(timeout=30) for f in futs]
            st = eng.stats.as_dict()
            assert st["requests"] == sum(len(v) for v in reqs)
            assert sum(st["close_reasons"].values()) == st["batches"]
            assert st["device_batches"] == st["batches"]
    for vs, a_r, a_p in zip(reqs, out["ref"], out["port"]):
        _assert_answers(a_p, a_r)
        _assert_answers(a_p, _expected(graph, vs))


def test_out_of_range_ids_raise_in_both(graph, tmp_path):
    path = write_pair(tmp_path, graph.offsets, graph.neighbors, "compbin")
    for side, engine_cls, kw in ((ref, RefEngine, {}),
                                 (port, PortEngine, {"device": "cpu"})):
        with _open(side, path) as g, engine_cls(g, **kw) as eng:
            for bad in ([-1], [graph.n_vertices], [0, 1 << 40]):
                with pytest.raises(ValueError, match="vertex ids must be in"):
                    eng.neighbors_batch(bad)
            assert eng.neighbors_batch([]) == []
            assert eng.stats.batches == 0


def test_constructor_contract(graph, tmp_path):
    path = write_pair(tmp_path, graph.offsets, graph.neighbors, "compbin")
    wg = write_pair(tmp_path, graph.offsets, graph.neighbors, "webgraph")
    with port.paragrapher.open_graph(path) as g:
        with pytest.raises(ValueError, match="decode must be one of"):
            PortEngine(g, decode="gpu", device="cpu")
        # a byte budget builds the hot-set tier, placed on the given device
        with PortEngine(g, hotset=1 << 20, device="cpu") as eng:
            assert eng.hotset.plan.budget_bytes == 1 << 20
            _assert_answers(eng.neighbors_batch([3]), _expected(graph, [3]))
        # pinned to the host, an engine needs no device at all
        with PortEngine(g, decode="host") as eng:
            assert eng.hotset is None
            _assert_answers(eng.neighbors_batch([3]), _expected(graph, [3]))
    with port.paragrapher.open_graph(wg) as g:
        with pytest.raises(ValueError, match="direct-addressing"):
            PortEngine(g, device="cpu")


def test_device_answers_are_copies_not_views(graph, tmp_path):
    path = write_pair(tmp_path, graph.offsets, graph.neighbors, "compbin")
    with port.paragrapher.open_graph(path) as g, \
            PortEngine(g, decode="device", device="cpu") as eng:
        hub = int(np.argmax(np.diff(graph.offsets)))
        a, b = eng.neighbors_batch([hub, 0])
        assert a.base is None and b.base is None


def test_query_stats_merge_and_reset_match(graph, tmp_path):
    path = write_pair(tmp_path, graph.offsets, graph.neighbors, "compbin")
    merged = {}
    for side, engine_cls, kw in ((ref, RefEngine, {}),
                                 (port, PortEngine, {"device": "cpu"})):
        with _open(side, path) as g, \
                engine_cls(g, decode="auto", **kw) as e1, \
                engine_cls(g, decode="host", **kw) as e2:
            for vs in _trace(graph.n_vertices, 5, 4):
                e1.neighbors_batch(vs)
                e2.neighbors_batch(vs[::-1])
            m = e1.stats.merge(e2.stats)
            snap = e1.stats.reset()
            assert stats_ints(snap)["batches"] == 4
            assert stats_ints(e1.stats)["batches"] == 0
            merged[side.name] = stats_ints(m)
    assert merged["port"] == merged["ref"]
