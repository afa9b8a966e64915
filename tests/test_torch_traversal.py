"""The traversal service, its admission gate and the virtual-clock load
generator: the port (``repro_torch.query``, engines on ``device="cpu"``)
against the JAX package on the same graphs, requests and seeds, and
against the pure in-memory CSR reference of
``tests/test_traversal_differential.py``.

Zero tolerance on integers: every result field (visit order, depths,
path, hops, edges scanned, truncation), every integer counter of
``TraversalStats`` / ``QueryStats`` / ``HotSetStats``, and — on the
virtual clock — every ``LoadReport`` field and latency sample.  The
cases of ``tests/test_traversal_{differential,service,loadgen}.py`` run
on the port; each compares with the reference where both can run it.
"""

import _torch_env  # noqa: F401  (first: one torch thread)
import errno
import os
import tempfile
import threading

import numpy as np
import pytest

from _torch_pair import port, ref, write_pair
from repro_torch.convert import stats_ints
from tests._prop import Draw, prop
from tests.conftest import FaultyStorage
from tests.test_traversal_differential import ref_traverse

SIDES = (ref, port)
BLOCK = 512


def _result(res) -> dict:
    """A traversal result as plain python values (latency left out)."""
    return {"kind": res.kind, "vertices": res.vertices.tolist(),
            "depths": res.depths.tolist(), "found": res.found,
            "path": None if res.path is None else res.path.tolist(),
            "truncated": res.truncated, "hops": res.hops,
            "edges_scanned": res.edges_scanned,
            "dtypes": (res.vertices.dtype.str, res.depths.dtype.str)}


def _matches_csr(res, want, ctx=""):
    got = _result(res)
    for key in ("vertices", "depths", "found", "path", "truncated", "hops",
                "edges_scanned"):
        assert got[key] == want[key], (key, ctx)


def _trav_ints(svc) -> dict:
    d = stats_ints(svc.stats)
    d.pop("latencies", None)
    return d


def _service(side, path, *, decode="host", hotset=None, block=BLOCK,
             tracer=True, **kw):
    g = side.paragrapher.open_graph(
        path, use_pgfuse=True, pgfuse_block_size=block, pgfuse_readahead=0,
        pgfuse_eviction="clock",
        **{k: kw.pop(k) for k in list(kw) if k.startswith("pgfuse_")})
    engine = side.query.NeighborQueryEngine(
        g, decode=decode, hotset=hotset, **side.dev,
        tracer=side.obs.Tracer(max_traces=100_000) if tracer else None)
    return side.query.TraversalService(engine, **kw), engine, g


def _close(svc, engine, g):
    svc.close(), engine.close(), g.close()


def _check_spans(side, svc, engine) -> None:
    """Span/stats conservation: valid trees, one request root per
    submitted traversal, shed events == shed counter, window_close events
    == close_reasons."""
    obs = side.obs
    traces = engine._tracer.drain()
    assert engine._tracer.dropped_traces == 0
    for root in traces:
        assert obs.verify_span_tree(root) == [], root.name
    st = svc.stats
    assert sum(1 for r in traces if r.tier == "request") == st.submitted
    assert obs.event_counts(traces, "shed") == st.shed
    counted = side.query.close_reason_counts(
        engine.stats.as_dict()["close_reasons"])
    assert obs.window_close_counts(traces) == \
        {k: v for k, v in counted.items() if v}


def _replay(draw_requests, csr, path, *, decode="host", hotset=None,
            block=BLOCK):
    """Run the same request list on both packages; results, traversal
    stats, engine stats and hot-set stats must be equal, and every port
    result must equal the CSR reference."""
    out = {}
    for side in SIDES:
        svc, engine, g = _service(side, path, decode=decode, hotset=hotset,
                                  block=block)
        try:
            results = []
            for method, args, kwargs, want in draw_requests:
                res = getattr(svc, method)(*args, **kwargs)
                if side is port:
                    _matches_csr(res, want, (method, kwargs))
                results.append(_result(res))
            # ONE engine batch per frontier
            assert engine.stats.batches == svc.stats.frontier_batches
            hs = (stats_ints(engine.hotset.stats)
                  if engine.hotset is not None else None)
            if hs is not None:
                assert engine.hotset.stats.conserved
                assert "hotset" in svc.as_dict()
            _check_spans(side, svc, engine)
            out[side.name] = (results, _trav_ints(svc),
                              stats_ints(engine.stats), hs)
        finally:
            _close(svc, engine, g)
    assert out["port"] == out["ref"]
    return out["port"]


def _draw_graph(draw, d, max_edges):
    csr = draw.csr(max_edges=max_edges)
    if csr.n_vertices == 0:
        return None, None
    gp = os.path.join(d, "g.cbin")
    ref.paragrapher.save_graph(gp, csr, format="compbin")
    return csr, gp


@prop(6)
def test_khop_and_bfs_match_reference_and_csr(draw: Draw):
    with tempfile.TemporaryDirectory() as d:
        csr, gp = _draw_graph(draw, d, 1500)
        if csr is None:
            return
        block = draw.choice([512, 1 << 12])
        hotset = draw.choice([None, 1 << 12, 1 << 16])
        reqs = []
        for _ in range(3):
            seeds = draw.vertex_batch(csr.n_vertices, max_size=24)
            if seeds.size == 0:
                continue
            k = draw.int(0, 4)
            max_edges = draw.choice([1 << 20,
                                     draw.int(0, max(1, csr.n_edges))])
            max_vertices = (None if draw.bool() else
                            draw.int(1, max(1, csr.n_vertices)))
            kw = dict(max_edges=max_edges, max_vertices=max_vertices)
            reqs.append(("khop", (seeds, k), kw,
                         ref_traverse(csr, "khop", seeds, k=k, **kw)))
            reqs.append(("bfs_visit", (seeds,), kw,
                         ref_traverse(csr, "bfs", seeds, **kw)))
        _replay(reqs, csr, gp, hotset=hotset, block=block)


@prop(6)
def test_shortest_path_matches_reference_and_csr(draw: Draw):
    with tempfile.TemporaryDirectory() as d:
        csr, gp = _draw_graph(draw, d, 1200)
        if csr is None:
            return
        reqs = []
        for _ in range(4):
            src = draw.int(0, csr.n_vertices - 1)
            dst = src if draw.bool() and draw.bool() else \
                draw.int(0, csr.n_vertices - 1)
            max_edges = draw.choice([1 << 20,
                                     draw.int(0, max(1, csr.n_edges))])
            max_depth = None if draw.bool() else draw.int(0, 3)
            reqs.append(("shortest_path", (src, dst),
                         dict(max_edges=max_edges, max_depth=max_depth),
                         ref_traverse(csr, "path", [src], k=max_depth,
                                      target=dst, max_edges=max_edges)))
        results = _replay(reqs, csr, gp)[0]
        for res in results:
            if res["found"]:
                p = res["path"]
                for a, b in zip(p[:-1], p[1:]):
                    assert b in csr.neighbors_of(a).tolist()


@prop(4)
def test_device_decode_arm_matches_host_and_reference(draw: Draw):
    """The port's device-decode arm (the kernel's plain version on the
    CPU) answers like its host arm, the reference's device arm and the
    CSR; every batch took the device path."""
    with tempfile.TemporaryDirectory() as d:
        csr, gp = _draw_graph(draw, d, 1500)
        if csr is None:
            return
        reqs = []
        for _ in range(3):
            seeds = draw.vertex_batch(csr.n_vertices, max_size=16)
            if seeds.size == 0:
                continue
            k = draw.int(0, 3)
            reqs.append(("khop", (seeds, k), {},
                         ref_traverse(csr, "khop", seeds, k=k)))
        dev = _replay(reqs, csr, gp, decode="device")
        host = _replay(reqs, csr, gp, decode="host")
        assert dev[0] == host[0]
        assert dev[2]["device_batches"] == dev[2]["batches"]


def test_bad_seeds_are_clean_per_request_errors(tmp_path):
    csr = ref.graph.rmat(7, 5, seed=9)
    gp = write_pair(tmp_path, csr.offsets, csr.neighbors, "compbin")
    out = {}
    for side in SIDES:
        svc, engine, g = _service(side, gp)
        try:
            n = csr.n_vertices
            for bad in ([n], [-1], [0, n + 7], []):
                with pytest.raises(side.query.TraversalError):
                    svc.khop(bad, k=1)
            with pytest.raises(side.query.TraversalError):
                svc.shortest_path(0, n)
            with pytest.raises(side.query.TraversalError):
                side.query.TraversalRequest("walk", [0])
            assert svc.gate.inflight == 0 and svc.gate.edges_inflight == 0
            res = svc.khop([0, 1], 2)
            _matches_csr(res, ref_traverse(csr, "khop", [0, 1], k=2))
            st = svc.stats
            assert st.failed == 5 and st.completed == 1 and st.conserved
            out[side.name] = (_result(res), _trav_ints(svc))
        finally:
            _close(svc, engine, g)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("decode", ["host", "device"])
def test_k0_and_duplicate_seeds(tmp_path, decode):
    csr = ref.graph.rmat(6, 4, seed=1)
    gp = write_pair(tmp_path, csr.offsets, csr.neighbors, "compbin")
    svc, engine, g = _service(port, gp, decode=decode)
    try:
        res = svc.khop([5, 3, 5, 5, 3], k=0)
        assert res.vertices.tolist() == [3, 5]
        assert res.depths.tolist() == [0, 0]
        assert res.edges_scanned == 0 and res.hops == 0
        assert not res.truncated
    finally:
        _close(svc, engine, g)


# -- faults and concurrency (tests/test_traversal_service.py) --------------

@pytest.fixture
def graph_file(tmp_path):
    csr = ref.graph.rmat(9, 7, seed=42)
    return write_pair(tmp_path, csr.offsets, csr.neighbors, "compbin"), csr


def _open_svc(side, path, **kw):
    kw.setdefault("pgfuse_retry_backoff_s", 0.0)
    return _service(side, path, tracer=False, **kw)


def _clean(side, path, *batches, k=3):
    svc, engine, g = _open_svc(side, path)
    try:
        return [svc.khop(b, k) for b in batches]
    finally:
        _close(svc, engine, g)


def _same(a, b):
    assert _result(a) == _result(b)


def test_transient_eio_mid_frontier_retries_transparently(graph_file):
    path, _ = graph_file
    out = {}
    for side in SIDES:
        svc, engine, g = _open_svc(side, path)
        probe = FaultyStorage().install_graph(g)
        want = svc.khop([3, 71], 3)
        n_calls = probe.n_calls
        _close(svc, engine, g)
        assert n_calls >= 3
        svc, engine, g = _open_svc(side, path, pgfuse_retries=2)
        fs = FaultyStorage()
        fs.fail_at[1] = OSError(errno.EIO, "flaky OST")
        fs.fail_at[n_calls // 2 + 1] = OSError(errno.EIO, "flaky OST")
        fs.install_graph(g)
        try:
            _same(svc.khop([3, 71], 3), want)
            assert g.pgfuse_stats().retried_reads == 2
            st = svc.stats
            assert st.completed == 1 and st.failed == 0 and st.conserved
            out[side.name] = (n_calls, fs.n_calls, _result(want))
        finally:
            _close(svc, engine, g)
    assert out["port"] == out["ref"]


def test_exhausted_retry_fails_cleanly_and_short_read_heals(graph_file):
    path, _ = graph_file
    [want] = _clean(port, path, [5, 200])
    svc, engine, g = _open_svc(port, path)
    fs = FaultyStorage()
    fs.fail_at[1] = OSError(errno.EIO, "flaky OST")
    fs.install_graph(g)
    try:
        with pytest.raises(OSError):
            svc.khop([5, 200], 3)
        assert svc.gate.inflight == 0 and svc.gate.edges_inflight == 0
        fs.truncate_at[fs.n_calls + 1] = 7
        _same(svc.khop([5, 200], 3), want)
        assert any(returned == 7 for _, _, _, returned in fs.calls)
        st = svc.stats
        assert st.failed == 1 and st.completed == 1 and st.conserved
    finally:
        _close(svc, engine, g)


def test_failed_request_leaves_sibling_inflight_intact(graph_file):
    path, _ = graph_file
    want_a, want_b = _clean(port, path, [9, 130], [77, 300])
    plan = port.policy.choose_admission(0.5, edge_budget=1 << 16,
                                        service_edges_per_s=5e6, servers=2)
    svc, engine, g = _open_svc(port, path)
    svc.gate.plan = plan
    fs = FaultyStorage().install_graph(g)
    try:
        req_a = port.query.TraversalRequest("khop", [9, 130], k=3,
                                            max_edges=1 << 16)
        req_b = port.query.TraversalRequest("khop", [77, 300], k=3,
                                            max_edges=1 << 16)
        assert svc.admit(req_a) and svc.admit(req_b)
        fs.fail_at[fs.n_calls + 1] = OSError(errno.EIO, "flaky OST")
        with pytest.raises(OSError):
            svc.perform(req_b)
        assert svc.gate.inflight == 1
        assert svc.stats.failed == 1 and svc.stats.inflight == 1
        res_a = svc.perform(req_a)
        svc.complete(req_a, 0.0)
        _same(res_a, want_a)
        _same(svc.khop([77, 300], 3), want_b)
        st = svc.stats
        assert st.conserved and st.inflight == 0
        assert svc.gate.inflight == 0 and svc.gate.edges_inflight == 0
    finally:
        _close(svc, engine, g)


def test_concurrent_submits_survive_fault_burst(graph_file):
    path, _ = graph_file
    batches = [[i * 17 % 500, i * 53 % 500] for i in range(6)]
    wants = _clean(port, path, *batches)
    svc, engine, g = _open_svc(port, path, pgfuse_retries=1)
    fs = FaultyStorage().install_graph(g)
    try:
        for i in range(1, 5):
            fs.fail_at[i] = OSError(errno.EIO, "flaky OST")
        futures = [svc.submit(port.query.TraversalRequest("khop", b, k=3))
                   for b in batches]
        ok = bad = 0
        for fut, want in zip(futures, wants):
            try:
                _same(fut.result(timeout=30), want)
                ok += 1
            except OSError:
                bad += 1
        st = svc.stats
        assert ok + bad == 6 == st.admitted
        assert st.completed == ok and st.failed == bad
        assert st.conserved and st.inflight == 0
        assert svc.gate.inflight == 0 and svc.gate.edges_inflight == 0
        assert g.pgfuse_stats().retried_reads >= 1
        for b, want in zip(batches, wants):
            _same(svc.khop(b, 3), want)
    finally:
        _close(svc, engine, g)


@pytest.mark.parametrize("decode", ["host", "device", "auto"])
def test_concurrent_frontiers_from_threads_match_sequential(graph_file,
                                                            decode):
    """Executor threads, each calling the engine (on the card each would
    launch the decode kernel on its own current stream): concurrent
    traversals answer exactly as the same requests run one at a time."""
    path, csr = graph_file
    rng = np.random.default_rng(3)
    reqs = [port.query.TraversalRequest(
        ("khop", "bfs", "path")[i % 3], [int(rng.integers(0, 512))],
        k=2 if i % 3 == 0 else None,
        target=int(rng.integers(0, 512)) if i % 3 == 2 else None,
        max_vertices=64 if i % 3 == 1 else None) for i in range(12)]
    plan = port.policy.choose_admission(10.0, edge_budget=1 << 20,
                                        service_edges_per_s=5e6, servers=4)
    svc, engine, g = _open_svc(port, path, decode=decode, admission=plan)
    try:
        seq = [_result(svc.request(r)) for r in reqs]
        futs = [svc.submit(r) for r in reqs]
        assert [_result(f.result(timeout=60)) for f in futs] == seq
        assert len(svc._executor._threads) > 1
        for r, res in zip(reqs, seq):
            want = ref_traverse(csr, r.kind, r.seeds, k=r.k,
                                target=r.target, max_edges=r.max_edges,
                                max_vertices=r.max_vertices)
            assert res["vertices"] == want["vertices"]
            assert res["path"] == want["path"]
        st = svc.stats
        assert st.completed == 24 and st.conserved
    finally:
        _close(svc, engine, g)


def test_latency_injection_only_slows_never_corrupts(graph_file):
    path, _ = graph_file
    [want] = _clean(port, path, [0, 1, 2])
    svc, engine, g = _open_svc(port, path)
    FaultyStorage(latency_s=1e-4).install_graph(g)
    try:
        _same(svc.khop([0, 1, 2], 3), want)
        assert g.pgfuse_stats().retried_reads == 0
        st = svc.stats
        assert st.completed == 1 and st.failed == 0 and st.conserved
    finally:
        _close(svc, engine, g)


def test_querystats_reset_atomic_under_concurrent_batches(graph_file):
    path, _ = graph_file
    g = port.paragrapher.open_graph(path, use_pgfuse=True,
                                    pgfuse_block_size=BLOCK,
                                    pgfuse_readahead=0,
                                    pgfuse_eviction="clock")
    engine = port.query.NeighborQueryEngine(g, decode="host")
    n_threads, per_thread = 4, 60
    start = threading.Event()

    def worker(tid):
        rng = np.random.default_rng(tid)
        start.wait()
        for _ in range(per_thread):
            engine.neighbors_batch(
                rng.integers(0, engine.n_vertices, 8).tolist())

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    try:
        for t in threads:
            t.start()
        start.set()
        snapshots, errors = [], []
        while any(t.is_alive() for t in threads):
            live = engine.stats.as_dict()
            if sum(live["close_reasons"].values()) != live["batches"]:
                errors.append(live)
            snapshots.append(engine.stats.reset())
        for t in threads:
            t.join()
        snapshots.append(engine.stats.reset())
        assert not errors
        for snap in snapshots:
            assert sum(snap.close_reasons.values()) == snap.batches
            assert snap.latencies.n <= snap.batches
        assert sum(s.batches for s in snapshots) + engine.stats.batches \
            == n_threads * per_thread
    finally:
        engine.close(), g.close()


def test_traversalstats_reset_carries_inflight(graph_file):
    path, _ = graph_file
    out = {}
    for side in SIDES:
        svc, engine, g = _open_svc(side, path)
        try:
            svc.khop([1, 2], 1)
            req = side.query.TraversalRequest("khop", [3], k=1)
            assert svc.admit(req)
            snap = svc.stats.reset()
            assert snap.conserved and svc.stats.conserved
            live = svc.stats
            svc.perform(req)
            svc.complete(req, 0.001)
            assert live.completed == 1 and live.inflight == 0
            assert live.conserved and svc.gate.inflight == 0
            out[side.name] = (stats_ints(snap), _trav_ints(svc))
        finally:
            _close(svc, engine, g)
    for d in out.values():
        d[0].pop("latencies", None)
    assert out["port"] == out["ref"]
    assert out["port"][0]["submitted"] == 1


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_traversal_stats_merge_and_reset_match(side):
    """``TraversalStats`` merge sums counters and kinds, keeps both
    conservation identities; the port's fold equals the reference's."""
    def mk(mod, *vals, kinds=(), lat=()):
        st = mod.TraversalStats()
        (st.submitted, st.admitted, st.shed, st.completed, st.failed,
         st.inflight) = vals
        for k in kinds:
            st.requests_by_kind[k] = st.requests_by_kind.get(k, 0) + 1
        for v in lat:
            st.latencies.add(v)
        return st

    folds = {}
    for s in SIDES:
        a = mk(s.query, 5, 4, 1, 3, 0, 1, kinds=["khop", "bfs"], lat=[0.1])
        b = mk(s.query, 7, 5, 2, 4, 1, 0, kinds=["khop"], lat=[0.2, 0.3])
        m = a.merge(b)
        assert m.conserved
        assert a.merge(b).merge(a).as_dict() == a.merge(b.merge(a)).as_dict()
        folds[s.name] = m.as_dict()
    assert folds["port"] == folds["ref"]
    assert folds[side.name]["requests_by_kind"] == {"khop": 2, "bfs": 1}


# -- the load generator (tests/test_traversal_loadgen.py) ------------------

SLO_S = 0.02
EDGE_BUDGET = 8192


def _plan(side):
    return side.policy.choose_admission(SLO_S, edge_budget=EDGE_BUDGET,
                                        service_edges_per_s=5.0e6,
                                        servers=1)


def _make_request(side):
    def make(rng: np.random.Generator, client_id: int):
        seeds = np.minimum(rng.zipf(1.8, size=3) - 1, 511)
        return side.query.TraversalRequest("khop", seeds, k=2,
                                           max_edges=EDGE_BUDGET)
    return make


@pytest.fixture(scope="module")
def load_graph(tmp_path_factory):
    csr = ref.graph.rmat(9, 6, seed=3)
    return write_pair(tmp_path_factory.mktemp("load"), csr.offsets,
                      csr.neighbors, "compbin")


def _load(side, gp, *, n_clients, think_s, seed=7, horizon_s=0.2):
    g = side.paragrapher.open_graph(gp, use_pgfuse=True,
                                    pgfuse_block_size=1 << 12,
                                    pgfuse_readahead=0,
                                    pgfuse_eviction="clock")
    engine = side.query.NeighborQueryEngine(g, decode="host")
    svc = side.query.TraversalService(engine, admission=_plan(side))
    try:
        report = side.query.LoadGenerator(
            svc, _make_request(side), n_clients=n_clients,
            horizon_s=horizon_s, think_s=think_s, backoff_s=0.01,
            seed=seed).run()
        return report, svc.stats.as_dict(), stats_ints(engine.stats)
    finally:
        svc.close(), engine.close(), g.close()


def test_plan_arithmetic():
    assert vars(_plan(port)) == vars(_plan(ref))
    plan = _plan(port)
    assert plan.max_inflight == 6
    assert plan.max_edges_inflight == 6 * EDGE_BUDGET


def test_light_load_admits_everything_under_slo(load_graph):
    report, st, _ = _load(port, load_graph, n_clients=2, think_s=0.005)
    assert report.submitted > 50 and report.shed == 0
    assert report.completed == report.admitted == report.submitted
    assert report.p99_s <= SLO_S
    assert st["submitted"] == report.submitted and st["inflight"] == 0
    assert st["admitted"] == st["completed"] + st["failed"]


def test_overload_sheds_but_admitted_requests_keep_slo(load_graph):
    light, _, _ = _load(port, load_graph, n_clients=2, think_s=0.005)
    heavy, st, _ = _load(port, load_graph, n_clients=48, think_s=0.0)
    assert heavy.shed > 0 and heavy.shed_rate > light.shed_rate
    assert heavy.shed_rate > 0.5
    assert heavy.p99_s <= SLO_S and light.p99_s <= SLO_S
    assert st["submitted"] == st["admitted"] + st["shed"]
    assert st["admitted"] == st["completed"] + st["failed"]
    assert st["inflight"] == 0 and st["shed_rate"] == heavy.shed_rate
    assert heavy.completed == heavy.admitted < heavy.submitted


@pytest.mark.parametrize("n_clients,think_s,seed", [(16, 0.001, 11),
                                                     (48, 0.0, 7)])
def test_same_seed_report_equals_the_reference(load_graph, n_clients,
                                               think_s, seed):
    """On the virtual clock the whole simulated day is a function of the
    seed, graph and config: the port's report — every latency sample,
    every shed decision — and the service's stats equal the reference's,
    and a rerun of the port equals itself."""
    out = {side.name: _load(side, load_graph, n_clients=n_clients,
                            think_s=think_s, seed=seed, horizon_s=0.1)
           for side in SIDES}
    (rp, sp, qp), (rr, sr, qr) = out["port"], out["ref"]
    assert rp.as_dict() == rr.as_dict()
    assert rp.latencies_s == rr.latencies_s
    assert sp == sr
    for q in (qp, qr):
        q.pop("latencies", None)
    assert qp == qr
    again, sa, _ = _load(port, load_graph, n_clients=n_clients,
                         think_s=think_s, seed=seed, horizon_s=0.1)
    assert again.latencies_s == rp.latencies_s and sa == sp
    other, _, _ = _load(port, load_graph, n_clients=n_clients,
                        think_s=think_s, seed=seed + 1, horizon_s=0.1)
    assert other.latencies_s != rp.latencies_s


def test_service_latency_window_sees_virtual_latencies(load_graph):
    _, st, _ = _load(port, load_graph, n_clients=8, think_s=0.001)
    assert st["n_latencies"] > 0
    assert st["p50_s"] <= st["p99_s"] <= SLO_S


def test_loadgen_cost_model_report_and_validation():
    res = port.query.TraversalResult(
        "khop", np.arange(3), np.zeros(3, np.int64), False, None, False,
        hops=2, edges_scanned=12345)
    assert port.query.default_cost_fn(res) == ref.query.default_cost_fn(res)
    rep = {}
    for side in SIDES:
        r = side.query.LoadReport(horizon_s=2.0, n_clients=3, submitted=10,
                                  admitted=8, shed=2, completed=8,
                                  latencies_s=[0.1, 0.2, 0.4])
        rep[side.name] = r.as_dict()
        for kw in (dict(n_clients=0, horizon_s=1.0),
                   dict(n_clients=1, horizon_s=0.0),
                   dict(n_clients=1, horizon_s=1.0, think_s=-1.0),
                   dict(n_clients=1, horizon_s=1.0, servers=0)):
            with pytest.raises(ValueError):
                side.query.LoadGenerator(object(), lambda rng, c: None, **kw)
    assert rep["port"] == rep["ref"]


# -- the serving entry point ------------------------------------------------

@pytest.mark.parametrize("shards,replication,hotset", [
    (1, 1, None), (1, 1, 1 << 20), (2, 2, 1 << 20)])
def test_serve_traversal_mix_matches_the_reference(tmp_path, shards,
                                                   replication, hotset):
    """``serve_traversal``'s mix through ``make_traversal_server`` on both
    packages: the same requests, draw for draw, give the same traversal,
    engine (fleet-merged when sharded) and hot-set counters."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve as port_serve

    n_requests, batch = 12, 8
    svc, close = ref_serve.make_traversal_server(
        str(tmp_path), shards=shards, replication=replication,
        hotset_bytes=hotset)
    try:
        rng = np.random.default_rng(0)
        n = svc.n_vertices
        for i in range(n_requests):     # serve_traversal's loop
            hot = rng.integers(0, max(1, n // 16), batch)
            cold = rng.integers(0, n, batch)
            seeds = np.where(rng.random(batch) < 0.5, hot, cold)
            if i % 3 == 0:
                svc.khop(seeds, k=2)
            elif i % 3 == 1:
                svc.bfs_visit(seeds[:1], max_vertices=4 * batch)
            else:
                svc.shortest_path(int(seeds[0]), int(seeds[1]))
        want = svc.as_dict()
    finally:
        close()
    got = port_serve.serve_traversal(
        n_requests=n_requests, batch=batch, workdir=str(tmp_path),
        shards=shards, replication=replication, hotset_bytes=hotset,
        device="cpu")
    for d in (want, got):
        for sec in ("traversal", "query"):
            for key in ("p50_s", "p99_s", "dedup_ratio"):
                d[sec].pop(key, None)
    assert got == want
    assert got["traversal"]["completed"] == n_requests
    assert ("hotset" in got) == (hotset is not None)


def test_cli_traversal_sharded_hotset_logs(tmp_path, caplog):
    from repro_torch.launch import serve as port_serve

    caplog.set_level("INFO", logger="repro_torch.serve")
    out = tmp_path / "m.json"
    port_serve.main(["--arch", "gcn-cora", "--reduced", "--device", "cpu",
                     "--traversal", "--requests", "32", "--batch", "8",
                     "--shards", "2", "--replication", "2",
                     "--hotset-bytes", "1048576",
                     "--workdir", str(tmp_path / "w"),
                     "--metrics-json", str(out)])
    text = caplog.text
    assert "traversal serve: 32 reqs" in text
    assert "hot set: hit rate" in text
    import json
    metrics = json.loads(out.read_text())["metrics"]
    assert metrics["traversal.completed"] == 32
    assert metrics["router.batches"] > 0 and metrics["hotset.lookups"] > 0
