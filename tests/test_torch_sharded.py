"""The sharded scatter-gather service and the stats merges its fleet
totals stand on: the port (``repro_torch.query.ShardedQueryService``,
every replica engine on ``device="cpu"``) against one engine over the
whole file, the JAX package's service, and the in-memory CSR.

Shard counts 1-4, replication 1-2, decode ``host`` / ``device`` /
``auto``: answers are byte-identical, and every integer of
``RouterStats``, the merged ``QueryStats`` and ``HotSetStats`` equals the
reference's (zero tolerance).  The cases of
``tests/test_sharded_{differential,faults,loadgen}.py`` and
``tests/test_stats_merge.py`` run on the port.
"""

import errno
import os
import tempfile
import threading

import numpy as np
import pytest

from _torch_pair import port, ref, write_pair
from repro.graph.partition import shard_ranges as ref_shard_ranges
from repro_torch.convert import stats_ints
from repro_torch.graph.partition import shard_ranges as port_shard_ranges
from tests._prop import Draw, prop
from tests.conftest import FaultyStorage
from tests.test_traversal_differential import ref_traverse

SIDES = (ref, port)
OPEN_KW = dict(pgfuse_block_size=512, pgfuse_readahead=0,
               pgfuse_eviction="clock")


def _sharded(side, path, *, n_shards=2, replication=1, decode="host",
             open_kw=None, tracer=False, **kw):
    if tracer:
        kw["tracer"] = side.obs.Tracer(max_traces=100_000)
    return side.query.ShardedQueryService(
        path, n_shards=n_shards, replication=replication, decode=decode,
        open_kwargs=dict(OPEN_KW, **(open_kw or {})),
        engine_kwargs=side.dev, **kw)


def _ints(stats) -> dict:
    d = stats_ints(stats)
    d.pop("latencies", None)
    return d


def _books(svc) -> dict:
    """Every integer the service keeps: router, merged and per-shard
    engine stats, and the fleet hot set."""
    hs = svc.hotset_stats()
    return {"router": svc.router.as_dict(), "stats": _ints(svc.stats),
            "per_shard": [_ints(s) for s in svc.per_shard_stats()],
            "hotset": None if hs is None else stats_ints(hs),
            "ranges": [tuple(map(int, r)) for r in svc.ranges]}


def _check_conservation(side, svc):
    assert svc.conserved
    merged = svc.stats
    per_shard = svc.per_shard_stats()
    for field in ("requests", "unique_vertices", "batches",
                  "blocks_touched", "coalesced_reads"):
        assert sum(getattr(s, field) for s in per_shard) == \
            getattr(merged, field), field
    rd = svc.router.as_dict()
    assert sum(rd["routed_by_shard"].values()) == rd["requests"]
    if rd["batches"]:
        assert rd["batches"] <= merged.batches \
            <= rd["batches"] * svc.n_shards
        assert sum(rd["shard_batches"].values()) == merged.batches
    hs = svc.hotset_stats()
    if hs is not None:
        assert hs.conserved
        per = [s for s in svc.per_shard_hotset_stats() if s is not None]
        for field in ("lookups", "hits", "fills", "admitted",
                      "resident_bytes"):
            assert sum(getattr(s, field) for s in per) == \
                getattr(hs, field), field
    tracer = svc._tracer
    if tracer.enabled:
        traces = tracer.drain()
        assert tracer.dropped_traces == 0
        for root in traces:
            assert side.obs.verify_span_tree(root) == [], root.name
        counted = side.query.close_reason_counts(
            merged.as_dict()["close_reasons"])
        assert side.obs.window_close_counts(traces) == \
            {k: v for k, v in counted.items() if v}


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    csr = ref.graph.rmat(10, 8, seed=5)
    d = tmp_path_factory.mktemp("sharded")
    return write_pair(d, csr.offsets, csr.neighbors, "compbin"), csr


def _batches(n_vertices, seed=0):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, n_vertices, s) for s in (1, 33, 300, 700)]
    out.append(np.repeat(rng.integers(0, 16, 4), 9))      # hub duplicates
    return out


@pytest.mark.parametrize("decode", ["host", "device", "auto"])
@pytest.mark.parametrize("replication", [1, 2])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_sharded_answers_equal_one_engine_reference_and_csr(
        graph, n_shards, replication, decode):
    gp, csr = graph
    batches = _batches(csr.n_vertices, seed=n_shards)
    out = {}
    for side in SIDES:
        with _sharded(side, gp, n_shards=n_shards, replication=replication,
                      decode=decode, tracer=True) as svc:
            answers = [svc.neighbors_batch(b) for b in batches]
            frontier = np.unique(batches[3])
            ragged = svc.neighbors_batch_ragged(frontier)
            _check_conservation(side, svc)
            out[side.name] = (answers, ragged, _books(svc))
    with port.paragrapher.open_graph(gp, use_pgfuse=True, **OPEN_KW) as g, \
            port.query.NeighborQueryEngine(g, decode=decode,
                                           device="cpu") as eng:
        one = [eng.neighbors_batch(b) for b in batches]
        one_ragged = eng.neighbors_batch_ragged(np.unique(batches[3]))
    (ans_p, rag_p, books_p), (ans_r, rag_r, books_r) = \
        out["port"], out["ref"]
    for b, a_p, a_r, a_1 in zip(batches, ans_p, ans_r, one):
        assert len(a_p) == len(b)
        for v, x, y, z in zip(b, a_p, a_r, a_1):
            assert x.dtype == np.int64
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
            np.testing.assert_array_equal(x, csr.neighbors_of(int(v)))
    for x, y, z in zip(rag_p, rag_r, one_ragged):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
        assert x.dtype == np.int64
    assert books_p == books_r
    if decode == "device":
        assert books_p["stats"]["device_batches"] == \
            books_p["stats"]["batches"]


def _draw_path(draw, d, max_edges):
    csr = draw.csr(max_edges=max_edges)
    if csr.n_vertices == 0:
        return None, None
    gp = os.path.join(d, "g.cbin")
    ref.paragrapher.save_graph(gp, csr, format="compbin")
    return csr, gp


@prop(5)
def test_sharded_traversals_match_reference(draw: Draw):
    """All three traversal kinds over the sharded frontier backend (shard
    counts 1-4, replication, optional per-replica hot sets, tight
    budgets): the port's results and books equal the reference's and the
    CSR reference."""
    with tempfile.TemporaryDirectory() as d:
        csr, gp = _draw_path(draw, d, 1500)
        if csr is None:
            return
        cfg = dict(n_shards=draw.choice([1, 2, 3, 4]),
                   replication=draw.choice([1, 1, 2]),
                   open_kw=dict(pgfuse_block_size=draw.choice([512,
                                                               1 << 12])))
        if draw.bool():
            cfg["hotset_bytes"] = draw.choice([1 << 12, 1 << 16])
        reqs = []
        for _ in range(2):
            seeds = draw.vertex_batch(csr.n_vertices, max_size=24)
            if seeds.size == 0:
                continue
            k = draw.int(0, 4)
            max_edges = draw.choice([1 << 20,
                                     draw.int(0, max(1, csr.n_edges))])
            max_vertices = (None if draw.bool() else
                            draw.int(1, max(1, csr.n_vertices)))
            reqs.append(("khop", (seeds, k), dict(
                max_edges=max_edges, max_vertices=max_vertices)))
            reqs.append(("bfs_visit", (seeds,), dict(
                max_edges=max_edges, max_vertices=max_vertices)))
            src = draw.int(0, csr.n_vertices - 1)
            dst = draw.int(0, csr.n_vertices - 1)
            reqs.append(("shortest_path", (src, dst),
                         dict(max_edges=max_edges)))
        out = {}
        for side in SIDES:
            svc = _sharded(side, gp, tracer=True, **cfg)
            trav = side.query.TraversalService(svc)
            try:
                results = []
                for method, args, kw in reqs:
                    res = getattr(trav, method)(*args, **kw)
                    results.append((res.vertices.tolist(),
                                    res.depths.tolist(), res.found,
                                    None if res.path is None
                                    else res.path.tolist(),
                                    res.truncated, res.hops,
                                    res.edges_scanned))
                assert svc.router.batches == trav.stats.frontier_batches
                _check_conservation(side, svc)
                out[side.name] = (results, _books(svc))
            finally:
                trav.close(), svc.close()
        assert out["port"] == out["ref"]
        for (method, args, kw), got in zip(reqs, out["port"][0]):
            if method == "khop":
                want = ref_traverse(csr, "khop", args[0], k=args[1], **kw)
            elif method == "bfs_visit":
                want = ref_traverse(csr, "bfs", args[0], **kw)
            else:
                want = ref_traverse(csr, "path", [args[0]], target=args[1],
                                    **kw)
            assert got == (want["vertices"], want["depths"], want["found"],
                           want["path"], want["truncated"], want["hops"],
                           want["edges_scanned"])


def test_routing_table_and_validation(tmp_path):
    csr = ref.graph.rmat(8, 5, seed=2)
    gp = write_pair(tmp_path, csr.offsets, csr.neighbors, "compbin")
    ranges = {}
    for side in SIDES:
        svc = _sharded(side, gp, n_shards=4)
        try:
            ranges[side.name] = [tuple(map(int, r)) for r in svc.ranges]
            assert svc.ranges[0][0] == 0
            assert svc.ranges[-1][1] == csr.n_vertices
            for s, (v0, v1) in enumerate(svc.ranges):
                for v in {v0, (v0 + v1) // 2, v1 - 1} if v0 < v1 else ():
                    assert svc.shard_of(v) == s
            assert svc.neighbors_batch([]) == []
            for bad in ([csr.n_vertices], [-1]):
                with pytest.raises(ValueError, match="vertex ids"):
                    svc.neighbors_batch(bad)
            np.testing.assert_array_equal(svc.neighbors_of(3),
                                          csr.neighbors_of(3))
        finally:
            svc.close()
        with pytest.raises(ValueError, match="closed"):
            svc.neighbors_batch([0])
        svc.close()
        for bad in (dict(n_shards=0), dict(replication=0),
                    dict(routing="random")):
            with pytest.raises(ValueError):
                side.query.ShardedQueryService(gp, **bad)
    assert ranges["port"] == ranges["ref"]


def test_more_shards_than_coverage(tmp_path):
    csr = ref.graph.rmat(4, 3, seed=5)
    gp = write_pair(tmp_path, csr.offsets, csr.neighbors, "compbin")
    out = {}
    for side in SIDES:
        with _sharded(side, gp, n_shards=4, n_parts=2) as svc:
            assert any(v0 == v1 for v0, v1 in svc.ranges)
            batch = np.arange(csr.n_vertices, dtype=np.int64)
            for v, nbrs in zip(batch, svc.neighbors_batch(batch)):
                np.testing.assert_array_equal(nbrs, csr.neighbors_of(int(v)))
            empty = {s for s, (v0, v1) in enumerate(svc.ranges) if v0 == v1}
            assert not (set(svc.router.routed_by_shard) & empty)
            _check_conservation(side, svc)
            out[side.name] = _books(svc)
    assert out["port"] == out["ref"]


def test_replication_round_robin_spreads_and_stays_identical(tmp_path):
    csr = ref.graph.rmat(8, 5, seed=7)
    gp = write_pair(tmp_path, csr.offsets, csr.neighbors, "compbin")
    with _sharded(port, gp, n_shards=2, replication=2) as svc:
        assert svc.routing == "rr"
        hub = svc.ranges[0][0]
        for _ in range(6):
            np.testing.assert_array_equal(svc.neighbors_batch([hub])[0],
                                          csr.neighbors_of(int(hub)))
        assert [rep.engine.stats.batches for rep in svc.replicas[0]] == \
            [3, 3]
        assert svc.replicas[1][0].engine.stats.batches == 0
        _check_conservation(port, svc)


@prop(8)
def test_shard_ranges_equal_the_reference(draw: Draw):
    csr = draw.csr(max_edges=1024)
    plan = draw.plan(csr)
    n_shards = draw.process_count()
    shares = draw.shares(n_shards) if draw.bool() else None
    got = port_shard_ranges(plan, n_shards, shares=shares)
    assert [tuple(map(int, r)) for r in got] == \
        [tuple(map(int, r)) for r in ref_shard_ranges(plan, n_shards,
                                                       shares=shares)]
    assert len(got) == n_shards


@pytest.mark.parametrize("args", [
    ((1 << 30,), dict(cache_budget_bytes=2 << 30)),
    ((8 << 30,), dict(cache_budget_bytes=2 << 30)),
    ((1 << 30,), dict(cache_budget_bytes=2 << 30, offered_edges_per_s=20e6,
                      shard_edges_per_s=5e6)),
    ((64 << 30,), dict(cache_budget_bytes=1 << 30, max_shards=16)),
    ((1 << 30,), dict(cache_budget_bytes=2 << 30, hot_fraction=0.7))])
def test_choose_shard_plan_matches(args):
    pos, kw = args
    assert vars(port.policy.choose_shard_plan(*pos, **kw)) == \
        vars(ref.policy.choose_shard_plan(*pos, **kw))


def test_service_from_shard_plan(tmp_path):
    csr = ref.graph.rmat(7, 4, seed=4)
    gp = write_pair(tmp_path, csr.offsets, csr.neighbors, "compbin")
    size = os.path.getsize(gp)
    plan = port.policy.choose_shard_plan(size,
                                         cache_budget_bytes=-(-size // 2),
                                         hot_fraction=0.8)
    assert plan.n_shards >= 2 and plan.replication == 2
    with port.query.ShardedQueryService(gp, plan=plan, open_kwargs=OPEN_KW,
                                        engine_kwargs=port.dev) as svc:
        assert svc.n_shards == plan.n_shards
        assert svc.replication == 2 and svc.routing == "rr"
        v = csr.n_vertices // 2
        np.testing.assert_array_equal(svc.neighbors_of(v),
                                      csr.neighbors_of(v))
    with port.query.ShardedQueryService(gp, plan=plan, replication=1,
                                        open_kwargs=OPEN_KW,
                                        engine_kwargs=port.dev) as svc:
        assert svc.replication == 1


# -- faults (tests/test_sharded_faults.py) ---------------------------------

FAULT_KW = dict(pgfuse_retry_backoff_s=0.0)


@pytest.fixture
def graph_file(tmp_path):
    csr = ref.graph.rmat(9, 7, seed=42)
    return write_pair(tmp_path, csr.offsets, csr.neighbors, "compbin"), csr


def _burst(fs: FaultyStorage, n: int = 400) -> FaultyStorage:
    start = fs.n_calls
    for i in range(start + 1, start + 1 + n):
        fs.fail_at[i] = OSError(errno.EIO, "dead OST")
    return fs


def test_eio_burst_confined_to_one_shard(graph_file):
    gp, csr = graph_file
    out = {}
    for side in SIDES:
        with _sharded(side, gp, open_kw=FAULT_KW) as svc:
            (a0, a1), (b0, b1) = svc.ranges
            fs = _burst(FaultyStorage().install_graph(
                svc.replicas[1][0].graph))
            healthy = np.arange(a0, a1, dtype=np.int64)[:64]
            sick = np.arange(b0, b1, dtype=np.int64)[:64]
            for _ in range(3):
                for v, nbrs in zip(healthy, svc.neighbors_batch(healthy)):
                    np.testing.assert_array_equal(nbrs,
                                                  csr.neighbors_of(int(v)))
            with pytest.raises(OSError):
                svc.neighbors_batch(sick)
            with pytest.raises(OSError):
                svc.neighbors_batch(np.concatenate([healthy[:4], sick[:4]]))
            rd = svc.router.as_dict()
            assert rd["failed_batches"] == 2 and rd["reroutes"] == 0
            assert svc.conserved
            fs.fail_at.clear()
            for v, nbrs in zip(sick, svc.neighbors_batch(sick)):
                np.testing.assert_array_equal(nbrs, csr.neighbors_of(int(v)))
            assert svc.conserved
            out[side.name] = _books(svc)
    assert out["port"] == out["ref"]


def test_failed_shard_is_clean_per_request_traversal_error(graph_file):
    gp, _ = graph_file
    with _sharded(port, gp, open_kw=FAULT_KW) as clean:
        t = port.query.TraversalService(clean)
        (h0, _), (s0, _) = clean.ranges
        healthy_seeds, sick_seeds = [int(h0), int(h0 + 1)], [int(s0)]
        want = t.khop(healthy_seeds, 2)
        t.close()
    with _sharded(port, gp, open_kw=FAULT_KW) as svc:
        trav = port.query.TraversalService(svc)
        _burst(FaultyStorage().install_graph(svc.replicas[1][0].graph))
        try:
            results, errors = [], []

            def run(seeds):
                try:
                    results.append(trav.khop(seeds, 2))
                except (OSError, port.query.TraversalError) as e:
                    errors.append(e)

            ts = [threading.Thread(target=run, args=(s,))
                  for s in (healthy_seeds, sick_seeds, healthy_seeds)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert len(errors) >= 1
            for res in results:
                if res.vertices.tolist() == want.vertices.tolist():
                    assert res.depths.tolist() == want.depths.tolist()
            st = trav.stats
            assert st.conserved and st.inflight == 0
            assert st.failed == len(errors)
            assert st.completed == len(results)
            assert trav.gate.inflight == 0 and trav.gate.edges_inflight == 0
            assert svc.conserved
        finally:
            trav.close()


def test_replicated_shard_fails_over_to_sibling(graph_file):
    gp, csr = graph_file
    out = {}
    for side in SIDES:
        with _sharded(side, gp, replication=2, open_kw=FAULT_KW) as svc:
            _burst(FaultyStorage().install_graph(svc.replicas[0][0].graph))
            v0 = svc.ranges[0][0]
            batch = np.arange(v0, v0 + 8, dtype=np.int64)
            for _ in range(4):
                for v, nbrs in zip(batch, svc.neighbors_batch(batch)):
                    np.testing.assert_array_equal(nbrs,
                                                  csr.neighbors_of(int(v)))
            rd = svc.router.as_dict()
            assert rd["reroutes"] == 2 and rd["failed_batches"] == 0
            assert svc.replicas[0][1].engine.stats.batches == 4
            assert svc.replicas[0][0].engine.stats.batches == 0
            assert svc.conserved
            out[side.name] = _books(svc)
    assert out["port"] == out["ref"]


def test_all_replicas_dead_surfaces_last_error(graph_file):
    gp, _ = graph_file
    with _sharded(port, gp, replication=2, open_kw=FAULT_KW) as svc:
        for r in range(2):
            _burst(FaultyStorage().install_graph(svc.replicas[0][r].graph))
        with pytest.raises(OSError, match="dead OST"):
            svc.neighbors_batch([svc.ranges[0][0]])
        rd = svc.router.as_dict()
        assert rd["reroutes"] == 1 and rd["failed_batches"] == 1
        assert svc.conserved


def test_per_mount_retries_heal_under_replication(graph_file):
    gp, csr = graph_file
    with _sharded(port, gp, replication=2,
                  open_kw=dict(FAULT_KW, pgfuse_retries=2)) as svc:
        target = svc.replicas[0][0]
        fs = FaultyStorage().install_graph(target.graph)
        fs.fail_at[1] = OSError(errno.EIO, "flaky OST")
        v0 = svc.ranges[0][0]
        np.testing.assert_array_equal(svc.neighbors_batch([v0])[0],
                                      csr.neighbors_of(int(v0)))
        assert target.graph.pgfuse_stats().retried_reads == 1
        rd = svc.router.as_dict()
        assert rd["reroutes"] == 0 and rd["failed_batches"] == 0
        assert svc.conserved


# -- overload on the virtual clock (tests/test_sharded_loadgen.py) ---------

SLO_S, EDGE_BUDGET, RATE = 0.02, 8192, 5.0e6


@pytest.fixture(scope="module")
def load_graph(tmp_path_factory):
    csr = ref.graph.rmat(9, 6, seed=3)
    return write_pair(tmp_path_factory.mktemp("sload"), csr.offsets,
                      csr.neighbors, "compbin")


def _overload(side, gp, *, shards, n_clients, seed=7, horizon_s=0.05):
    svc = _sharded(side, gp, n_shards=shards,
                   open_kw=dict(pgfuse_block_size=1 << 12))
    plan = side.policy.choose_admission(SLO_S, edge_budget=EDGE_BUDGET,
                                        service_edges_per_s=RATE * shards,
                                        servers=shards)
    trav = side.query.TraversalService(svc, admission=plan)

    def make(rng, client_id):
        seeds = np.minimum(rng.zipf(1.8, size=3) - 1, 511)
        return side.query.TraversalRequest("khop", seeds, k=2,
                                           max_edges=EDGE_BUDGET)

    try:
        report = side.query.LoadGenerator(
            trav, make, n_clients=n_clients, horizon_s=horizon_s,
            think_s=0.0, backoff_s=0.01, servers=shards, seed=seed).run()
        return report, trav.stats.as_dict(), svc.router.as_dict()
    finally:
        trav.close(), svc.close()


def test_two_shards_shed_less_at_equal_offered_load(load_graph):
    one, st1, _ = _overload(port, load_graph, shards=1, n_clients=48)
    two, st2, rd2 = _overload(port, load_graph, shards=2, n_clients=48)
    assert one.shed > 0 and two.shed_rate < one.shed_rate
    assert two.completed > one.completed
    assert one.p99_s <= SLO_S and two.p99_s <= SLO_S
    for st in (st1, st2):
        assert st["submitted"] == st["admitted"] + st["shed"]
        assert st["admitted"] == st["completed"] + st["failed"]
        assert st["inflight"] == 0
    assert set(rd2["routed_by_shard"]) == {0, 1}


def test_sharded_overload_run_equals_the_reference(load_graph):
    """Same seed, same graph, same shard count: the port's report (every
    latency sample), traversal stats and router books equal the
    reference's on the virtual clock."""
    out = {side.name: _overload(side, load_graph, shards=2, n_clients=8,
                                seed=11)
           for side in SIDES}
    (rp, sp, bp), (rr, sr, br) = out["port"], out["ref"]
    assert rp.as_dict() == rr.as_dict()
    assert rp.latencies_s == rr.latencies_s
    assert sp == sr and bp == br


# -- stats merges (tests/test_stats_merge.py) ------------------------------

def _qstats(mod, requests=0, unique=0, batches=0, reasons=(), lat=()):
    st = mod.QueryStats()
    st.requests, st.unique_vertices, st.batches = requests, unique, batches
    for r in reasons:
        st.close_reasons[r] = st.close_reasons.get(r, 0) + 1
    for v in lat:
        st.latencies.add(v)
    return st


def test_query_stats_merge_sums_associative_and_matches():
    out = {}
    for side in SIDES:
        q = side.query
        a = _qstats(q, 10, 4, 2, ["direct", "full"], [0.1, 0.2])
        b = _qstats(q, 6, 3, 3, ["direct", "timeout", "direct"], [0.3])
        c = _qstats(q, 9, 9, 1, ["plateau"], [0.5])
        m = a.merge(b)
        assert (m.requests, m.unique_vertices, m.batches) == (16, 7, 5)
        assert sum(m.close_reasons.values()) == m.batches
        assert a.requests == 10 and b.requests == 6
        left, right = a.merge(b).merge(c), a.merge(b.merge(c))
        assert left.as_dict() == right.as_dict()
        assert left.latencies == right.latencies
        assert q.merge_query_stats([a, b, c]).as_dict() == left.as_dict()
        assert q.merge_query_stats([]).requests == 0
        assert a.merge(a).requests == 20
        out[side.name] = (m.as_dict(), left.as_dict(),
                          dict(left.latencies.counts))
    assert out["port"] == out["ref"]


def test_query_stats_concurrent_merge_vs_fold_vs_reset():
    st = port.query.QueryStats()
    n_folds, n_threads = 400, 4
    absorbed, bad = [], []

    def fold():
        for _ in range(n_folds):
            with st._lock:
                st.requests += 3
                st.batches += 1
                st.close_reasons["direct"] = \
                    st.close_reasons.get("direct", 0) + 1
                st.latencies.add(0.001)

    def resetter():
        for _ in range(50):
            absorbed.append(st.reset())

    def merger():
        for _ in range(100):
            m = st.merge(st)
            if sum(m.close_reasons.values()) != m.batches:
                bad.append(m)

    threads = [threading.Thread(target=fold) for _ in range(n_threads)]
    threads += [threading.Thread(target=resetter),
                threading.Thread(target=merger)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad
    total = port.query.merge_query_stats(absorbed + [st])
    assert total.batches == n_folds * n_threads
    assert total.requests == 3 * n_folds * n_threads
    assert total.close_reasons == {"direct": n_folds * n_threads}
    assert total.latencies.n == n_folds * n_threads


def test_traversal_stats_concurrent_merge_vs_reset():
    st = port.query.TraversalStats()
    n_req = 300
    absorbed, bad = [], []

    def lifecycle():
        for _ in range(n_req):
            with st._lock:
                st.submitted += 1
                st.admitted += 1
                st.inflight += 1
            with st._lock:
                st.inflight -= 1
                st.completed += 1
                st.latencies.add(0.001)

    def resetter():
        for _ in range(40):
            absorbed.append(st.reset())

    def merger():
        for _ in range(80):
            m = st.merge(st)
            if not m.conserved:
                bad.append(m.as_dict())

    threads = [threading.Thread(target=lifecycle) for _ in range(3)]
    threads += [threading.Thread(target=resetter),
                threading.Thread(target=merger)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad
    total = port.query.TraversalStats()
    for s in absorbed + [st]:
        total = total.merge(s)
    assert total.submitted == total.admitted == total.completed == 3 * n_req
    assert total.inflight == 0 and total.shed == 0 and total.conserved
    assert total.latencies.n == 3 * n_req


def test_latency_histogram_merge_exactly_associative_and_matches():
    rng = np.random.default_rng(7)
    samples = rng.lognormal(mean=-6.0, sigma=2.0, size=9000)
    out = {}
    for side in SIDES:
        parts = [side.obs.LatencyHistogram() for _ in range(3)]
        for i, v in enumerate(samples):
            parts[i % 3].add(float(v))
        a, b, c = parts
        left = a.merge(b).merge(c)
        assert left == a.merge(b.merge(c)) == c.merge(a).merge(b)
        assert left.n == samples.size
        out[side.name] = (dict(left.counts), left.quantile(0.5),
                          left.quantile(0.99), left.min_s, left.max_s)
    assert out["port"] == out["ref"]
    const = _qstats(port.query, lat=[0.00308] * 37)
    assert const.latency_quantile(0.5) == 0.00308
    assert const.latency_quantile(0.99) == 0.00308
    assert port.query.QueryStats().latency_quantile(0.5) == 0.0
    assert port.query.TraversalStats().latency_quantile(0.99) == 0.0
