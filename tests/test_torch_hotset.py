"""The hot-set tier: the port's :mod:`repro_torch.query.hotset` against
the JAX package's on the same call sequences, and the port's engine with
the tier against the reference engine and the in-memory CSR.

Every mechanism of ``tests/test_hotset.py`` replays on BOTH packages
(admission, clock eviction, pinning, prefetch prediction are pure
functions of the call sequence) and the resulting ``HotSetStats`` and
resident sets must be equal — zero tolerance on every integer.  The hot
arms of ``tests/test_serving_differential.py`` run the port's engines
(host / device / auto decode, ``device="cpu"``) with a hot set beside the
reference's on the same graphs and traces.  Device placement: an int32
tensor per entry on the cache's device, re-widened to an independent
int64 array per hit; no GPU and ``device=None`` raises.
"""

import errno
import os
import tempfile

import numpy as np
import pytest
import torch

from _torch_pair import port, ref, write_pair
from repro_torch.convert import stats_ints
from repro_torch.query.hotset import HISTORY_WINDOW
from tests._prop import Draw, prop
from tests.conftest import FaultyStorage

SIDES = (ref, port)


def _run(v: int, degree: int) -> np.ndarray:
    """A recognizable synthetic decoded run for vertex ``v``."""
    return (np.arange(degree, dtype=np.int64) + 7 * v) % (1 << 20)


def _cache(side, budget_edges: int, *, min_degree=4, pin_degree=64,
           place="host", **kw):
    return side.query.HotSetCache(
        budget_bytes=budget_edges * side.query.BYTES_PER_EDGE,
        min_degree=min_degree, pin_degree=pin_degree, place=place,
        **kw, **(side.dev if place == "device" else {}))


def _state(cache) -> dict:
    """Everything observable about a cache, as plain ints and lists."""
    return {"stats": stats_ints(cache.stats),
            "resident": cache.resident_vertices.tolist(),
            "pinned": [v for v in cache.resident_vertices.tolist()
                       if cache.is_pinned(v)],
            "resident_bytes": cache.resident_bytes}


def _both(scenario) -> dict:
    """Run ``scenario(side)`` on both packages; the returned states must
    be equal.  Returns the port's."""
    got = {side.name: scenario(side) for side in SIDES}
    assert got["port"] == got["ref"]
    return got["port"]


# -- policy and constructor ------------------------------------------------

@pytest.mark.parametrize("args", [
    (1000, 16000, 1 << 20, {}), (1000, 900, 1 << 20, {}),
    ((1 << 31) + 1, 1 << 33, 1 << 20, {}),
    (4096, 65536, 12345, dict(pin_fraction=0.25, prefetch_min_hits=2,
                              prefetch_batch=3)),
    (0, 0, 1, {})])
def test_choose_hotset_admission_matches(args):
    *pos, kw = args
    a = ref.policy.choose_hotset_admission(*pos, **kw)
    b = port.policy.choose_hotset_admission(*pos, **kw)
    assert vars(a) == vars(b)
    assert a.device == b.device


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_cache_constructor_validation(side):
    HotSetCache = side.query.HotSetCache
    with pytest.raises(ValueError, match="plan= or budget_bytes="):
        HotSetCache()
    with pytest.raises(ValueError, match="budget_bytes"):
        HotSetCache(budget_bytes=0)
    with pytest.raises(ValueError, match="place"):
        HotSetCache(budget_bytes=1, place="tpu")
    with pytest.raises(ValueError, match="pin_fraction"):
        HotSetCache(budget_bytes=1, pin_fraction=-0.1)
    plan = side.policy.choose_hotset_admission(100, 1600, 1 << 20)
    c = HotSetCache(plan=plan, min_degree=1, place="host")
    assert c.plan.min_degree == 1 and c.plan.place == "host"
    assert c.plan.budget_bytes == 1 << 20


def test_device_placement_never_falls_back_to_host(monkeypatch, tmp_path):
    """``device=None`` is the GPU: with none, a device-placed cache (and
    an engine building one from a byte budget, whatever its decode mode)
    raises instead of keeping its runs in host memory; a host-placed
    cache needs no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    HotSetCache = port.query.HotSetCache
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HotSetCache(budget_bytes=1 << 10, place="device")
    plan = port.policy.choose_hotset_admission(100, 1600, 1 << 20)
    assert plan.place == "device"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HotSetCache(plan=plan)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HotSetCache(plan=plan, device="cuda")
    assert HotSetCache(budget_bytes=1 << 10, place="host").plan.place == \
        "host"
    csr = ref.graph.rmat(7, 4, seed=1)
    gp = write_pair(tmp_path, csr.offsets, csr.neighbors, "compbin")
    with port.paragrapher.open_graph(gp) as g:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.query.NeighborQueryEngine(g, decode="host", hotset=1 << 16)
        with port.query.NeighborQueryEngine(
                g, decode="host", hotset=1 << 16, device="cpu") as e:
            assert e.hotset.plan.place == "device"
            assert e.hotset._device == torch.device("cpu")


def test_device_store_is_int32_and_hits_are_independent_int64():
    cache = _cache(port, 1000, place="device")
    run = _run(3, 40)
    assert cache.fill(3, run)
    entry = cache._entries[3]
    assert isinstance(entry.store, torch.Tensor)
    assert entry.store.dtype == torch.int32
    assert entry.store.device == torch.device("cpu")
    a = cache.lookup(np.array([3]))[3]
    b = cache.lookup(np.array([3]))[3]
    assert a.dtype == np.int64 and np.array_equal(a, run)
    a[:] = -1                      # a caller scribbling on its answer
    assert np.array_equal(b, run)
    assert np.array_equal(cache.lookup(np.array([3]))[3], run)
    # the budget charges 8 bytes an edge, as the JAX package does, for
    # either placement
    assert cache.stats.resident_bytes == 40 * port.query.BYTES_PER_EDGE
    assert port.query.BYTES_PER_EDGE == ref.query.BYTES_PER_EDGE == 8


# -- admission / eviction churn --------------------------------------------

@pytest.mark.parametrize("place", ["host", "device"])
def test_degree_pinned_hub_survives_churn_and_cold_tail_bypasses(place):
    def scenario(side):
        cache = _cache(side, 1000, min_degree=4, pin_degree=64,
                       place=place)
        assert cache.fill(0, _run(0, 100))          # the hub: pinned
        for v in range(1000, 1040):
            assert not cache.fill(v, _run(v, 3))     # cold tail bypasses
        for v in range(1, 91):                      # warm middle churn
            cache.fill(v, _run(v, 20))
        got = cache.lookup(np.array([0], dtype=np.int64))
        assert got[0].dtype == np.int64
        assert np.array_equal(got[0], _run(0, 100))
        return _state(cache)

    st = _both(scenario)
    s = st["stats"]
    assert s["evicted"] > 0 and s["bypassed"] == 40
    assert 0 in st["pinned"]
    assert not set(st["resident"]) & set(range(1000, 1040))
    assert s["lookups"] == s["hits"] + s["misses"]
    assert s["fills"] == s["admitted"] + s["bypassed"] + s["rejected"]
    assert 100 * 8 <= s["resident_bytes"] <= 1000 * 8


def test_clock_sweep_gives_second_chances():
    def scenario(side):
        cache = _cache(side, 48, min_degree=4, pin_degree=1 << 62)
        for v in (1, 2, 3):
            assert cache.fill(v, _run(v, 16))
        assert cache.fill(4, _run(4, 16))
        assert cache.resident_vertices.tolist() == [2, 3, 4]
        cache.lookup(np.array([2], dtype=np.int64))
        assert cache.fill(5, _run(5, 16))
        assert np.array_equal(cache.lookup(np.array([2]))[2], _run(2, 16))
        return _state(cache)

    st = _both(scenario)
    assert st["resident"] == [2, 4, 5] and st["stats"]["evicted"] == 2


def test_oversized_unmakeable_room_and_pin_fraction():
    def scenario(side):
        cache = _cache(side, 100, min_degree=2, pin_degree=8,
                       pin_fraction=1.0)
        assert not cache.fill(1, _run(1, 101))       # > budget
        assert cache.fill(2, _run(2, 90))            # pinned
        assert not cache.fill(3, _run(3, 20))        # no unpinned victim
        capped = _cache(side, 100, min_degree=2, pin_degree=10,
                        pin_fraction=0.5)
        assert capped.fill(1, _run(1, 40))
        assert capped.fill(2, _run(2, 40))           # breaches the cap
        return {"a": _state(cache), "b": _state(capped)}

    st = _both(scenario)
    assert st["a"]["stats"]["rejected"] == 2
    assert st["b"]["pinned"] == [1] and st["b"]["stats"]["pinned"] == 1


def test_clear_drops_entries_keeps_flow_history():
    def scenario(side):
        cache = _cache(side, 100, place="device")
        cache.fill(1, _run(1, 10))
        cache.lookup(np.array([1]))
        cache.clear()
        assert cache.resident_bytes == 0
        return _state(cache)

    st = _both(scenario)
    assert st["stats"]["hits"] == 1 and st["stats"]["fills"] == 1
    assert st["stats"]["resident_entries"] == 0 and st["resident"] == []


# -- stats -----------------------------------------------------------------

def _stats(side, **kw):
    return side.query.HotSetStats(**kw)


A = dict(lookups=10, hits=7, misses=3, fills=5, admitted=3, bypassed=1,
         rejected=1, evicted=2, pinned=1, prefetch_fills=1, hit_edges=70,
         resident_bytes=800, resident_entries=1)
B = dict(lookups=4, hits=1, misses=3, fills=2, admitted=1, bypassed=1,
         evicted=1, hit_edges=9, resident_bytes=80, resident_entries=1)
C = dict(lookups=1, misses=1)


def test_stats_merge_associative_and_conserved():
    out = {}
    for side in SIDES:
        a, b, c = (_stats(side, **kw) for kw in (A, B, C))
        ab_c = a.merge(b).merge(c)
        assert ab_c.as_dict() == a.merge(b.merge(c)).as_dict()
        assert ab_c.conserved
        folded = side.query.merge_hotset_stats([a, b, c])
        assert folded.as_dict() == ab_c.as_dict()
        assert side.query.merge_hotset_stats([]).lookups == 0
        assert "_lock" not in a.as_dict()
        out[side.name] = (ab_c.as_dict(), a.as_dict())
    assert out["port"] == out["ref"]
    assert out["port"][0]["resident_bytes"] == 880
    assert out["port"][1]["hit_rate"] == 0.7


def test_stats_reset_keeps_resident_gauges():
    out = {}
    for side in SIDES:
        st = _stats(side, lookups=5, hits=2, misses=3, resident_bytes=640,
                    resident_entries=2, pinned=1)
        snap = st.reset()
        out[side.name] = (stats_ints(snap), stats_ints(st))
    assert out["port"] == out["ref"]
    snap, live = out["port"]
    assert snap["lookups"] == 5 and live["lookups"] == 0
    assert (live["resident_bytes"], live["resident_entries"],
            live["pinned"]) == (640, 2, 1)


# -- trace-driven prefetch -------------------------------------------------

def test_prefetch_predicts_hot_and_never_refetches_bypassed():
    def scenario(side):
        cache = _cache(side, 100, min_degree=4, prefetch_min_hits=2,
                       prefetch_batch=4)
        ids = np.array([5, 9], dtype=np.int64)
        seen = []
        cache.observe(ids)
        seen.append(cache.prefetch_candidates().tolist())
        cache.observe(ids)
        seen.append(sorted(cache.prefetch_candidates().tolist()))
        seen.append(cache.prefetch_candidates().tolist())
        assert not cache.fill(5, _run(5, 2), prefetch=True)
        cache.observe(ids), cache.observe(ids)
        seen.append(cache.prefetch_candidates().tolist())
        assert cache.fill(9, _run(9, 10), prefetch=True)
        cache.fill(50, _run(50, 95))
        cache.observe(ids)
        seen.append(cache.prefetch_candidates().tolist())
        return {"seen": seen, **_state(cache)}

    st = _both(scenario)
    assert st["seen"][:4] == [[], [5, 9], [], []]
    assert 9 in st["seen"][4] and 9 not in st["resident"]
    assert st["stats"]["prefetch_fills"] == 1


def test_prefetch_frequency_window_decays():
    from repro.query.hotset import HISTORY_WINDOW as REF_WINDOW

    assert HISTORY_WINDOW == REF_WINDOW

    def scenario(side):
        cache = _cache(side, 100, prefetch_min_hits=2, prefetch_batch=4)
        cache.observe(np.array([7, 7], dtype=np.int64))
        cache.observe(np.arange(10_000, 10_000 + HISTORY_WINDOW,
                                dtype=np.int64))
        return cache.prefetch_candidates().tolist()

    assert 7 not in _both(scenario)


# -- engine integration ----------------------------------------------------

@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    csr = ref.graph.rmat(11, 8, seed=3)
    d = tmp_path_factory.mktemp("hot")
    return write_pair(d, csr.offsets, csr.neighbors, "compbin"), csr


def _open(side, gp, **kw):
    return side.paragrapher.open_graph(gp, use_pgfuse=True,
                                       pgfuse_block_size=512,
                                       pgfuse_readahead=0,
                                       pgfuse_eviction="clock", **kw)


def _hub_trace(csr, n_batches=6, size=48, seed=0):
    degrees = np.diff(csr.offsets)
    hubs = np.argsort(degrees)[::-1][:16].astype(np.int64)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        cold = rng.integers(0, csr.n_vertices, size)
        out.append(np.where(rng.random(size) < 0.5,
                            hubs[rng.integers(0, len(hubs), size)], cold))
    return out


def _hot_engine_run(side, gp, csr, trace, decode, cache_kw):
    """One engine with a hot set over ``trace``: answers (held to the
    CSR here) and every integer counter of both stats objects."""
    with _open(side, gp) as g, side.query.NeighborQueryEngine(
            g, decode=decode, **side.dev,
            hotset=side.query.HotSetCache(**cache_kw, **(
                side.dev if cache_kw.get("place") == "device" else {}))
            ) as eng:
        answers = []
        for ids in trace:
            got = eng.neighbors_batch(ids)
            for v, nbrs in zip(ids, got):
                assert nbrs.dtype == np.int64
                np.testing.assert_array_equal(nbrs,
                                              csr.neighbors_of(int(v)))
            answers.append(got)
        hs = eng.hotset.stats
        assert hs.conserved
        assert hs.resident_bytes <= eng.hotset.plan.budget_bytes
        return answers, stats_ints(eng.stats), stats_ints(hs), \
            eng.hotset.resident_vertices.tolist()


@pytest.mark.parametrize("decode", ["host", "device", "auto"])
@pytest.mark.parametrize("place", ["host", "device"])
def test_engine_hot_answers_equal_every_decode_path(graph, decode, place):
    """The port's engine with a hot set answers byte-identically to the
    CSR and to the reference engine with the same tier, on every decode
    path; hits happen, and every integer counter of ``QueryStats`` and
    ``HotSetStats`` equals the reference's."""
    gp, csr = graph
    degrees = np.diff(csr.offsets)
    cache_kw = dict(budget_bytes=1 << 18, min_degree=2,
                    pin_degree=int(degrees.max()), place=place,
                    prefetch_min_hits=2, prefetch_batch=4)
    trace = _hub_trace(csr)
    r = _hot_engine_run(ref, gp, csr, trace, decode, cache_kw)
    p = _hot_engine_run(port, gp, csr, trace, decode, cache_kw)
    for a_r, a_p in zip(r[0], p[0]):
        for x, y in zip(a_r, a_p):
            np.testing.assert_array_equal(x, y)
    assert p[1:] == r[1:]
    assert p[2]["hits"] > 0
    if decode == "device":
        assert p[1]["device_batches"] == p[1]["batches"]


def test_engine_builds_tier_from_int_plan_and_cache(graph):
    gp, csr = graph
    plan = port.policy.choose_hotset_admission(csr.n_vertices, csr.n_edges,
                                               1 << 16, prefetch_min_hits=2)
    for hs in (1 << 16, plan, port.query.HotSetCache(plan=plan,
                                                     device="cpu")):
        with _open(port, gp) as g:
            e = port.query.NeighborQueryEngine(g, decode="host", hotset=hs,
                                               device="cpu")
            assert e.hotset is not None
            assert e.hotset.plan.budget_bytes == 1 << 16
            for v, nbrs in zip([0, 1, 2, 1],
                               e.neighbors_batch([0, 1, 2, 1])):
                np.testing.assert_array_equal(nbrs, csr.neighbors_of(v))
    with _open(port, gp) as g:
        assert port.query.NeighborQueryEngine(g, device="cpu").hotset \
            is None


@pytest.mark.parametrize("decode", ["host", "device"])
def test_hotset_fills_under_storage_faults(graph, decode):
    """Deterministic transient EIOs while the tier fills and prefetches:
    retries absorb them, answers stay correct, resident runs hold the
    true bytes — and the port's counters (hot set, queries, retried
    reads, underlying calls) equal the reference's."""
    gp, csr = graph
    out = {}
    for side in SIDES:
        g = _open(side, gp, pgfuse_retries=3, pgfuse_retry_backoff_s=0.0)
        try:
            inj = FaultyStorage()
            for k in (1, 3, 6, 9):
                inj.fail_at[k] = OSError(errno.EIO, "flaky OST")
            inj.install_graph(g)
            engine = side.query.NeighborQueryEngine(
                g, decode=decode, **side.dev,
                hotset=side.query.HotSetCache(
                    budget_bytes=1 << 16, min_degree=1, place="device",
                    prefetch_min_hits=2, prefetch_batch=4, **side.dev))
            ids = np.arange(24, dtype=np.int64)
            for _ in range(3):
                for v, nbrs in zip(ids, engine.neighbors_batch(ids)):
                    np.testing.assert_array_equal(
                        nbrs, csr.neighbors_of(int(v)))
            hs = engine.hotset.stats
            assert hs.conserved and hs.hits > 0
            for v in engine.hotset.resident_vertices.tolist():
                got = engine.hotset._fetch(engine.hotset._entries[v])
                np.testing.assert_array_equal(got, csr.neighbors_of(v))
            out[side.name] = (stats_ints(hs), stats_ints(engine.stats),
                              g.pgfuse_stats().retried_reads, inj.n_calls)
        finally:
            g.close()
    assert out["port"] == out["ref"]
    assert out["port"][2] >= 1


def test_sharded_per_shard_hotsets(graph):
    gp, csr = graph
    okw = dict(pgfuse_block_size=512, pgfuse_readahead=0)
    out = {}
    for side in SIDES:
        with side.query.ShardedQueryService(
                gp, n_shards=2, hotset_bytes=1 << 16, open_kwargs=okw,
                engine_kwargs=side.dev) as svc:
            ids = np.arange(0, csr.n_vertices, 7, dtype=np.int64)
            for _ in range(2):
                for v, nbrs in zip(ids, svc.neighbors_batch(ids)):
                    np.testing.assert_array_equal(
                        nbrs, csr.neighbors_of(int(v)))
            hs = svc.hotset_stats()
            assert hs is not None and hs.conserved
            per = [s for s in svc.per_shard_hotset_stats() if s is not None]
            assert len(per) == 2
            assert sum(s.lookups for s in per) == hs.lookups
            out[side.name] = (stats_ints(hs),
                              [stats_ints(s) for s in per])
        with side.query.ShardedQueryService(
                gp, n_shards=2, open_kwargs=okw,
                engine_kwargs=side.dev) as svc:
            assert svc.hotset_stats() is None
            assert all(s is None for s in svc.per_shard_hotset_stats())
    assert out["port"] == out["ref"]


# -- the hot arms of the serving differential ------------------------------

def _hot_cache_kw(draw: Draw) -> dict:
    """A tier sized to be BUSY on Draw-scale graphs (admit from degree 1;
    the tiny budget arm churns)."""
    return dict(budget_bytes=draw.choice([1 << 10, 1 << 16]), min_degree=1,
                pin_degree=draw.choice([4, 1 << 62]),
                place=draw.choice(["host", "device"]),
                prefetch_min_hits=2, prefetch_batch=4)


def _zipf_trace(draw: Draw, n_vertices: int, n_batches: int) -> list:
    hubs = draw.ints(0, n_vertices - 1, max(4, n_vertices // 16))
    trace = []
    for _ in range(n_batches):
        ids = draw.vertex_batch(n_vertices, max_size=96)
        if ids.size and draw.bool():
            k = draw.int(1, max(1, ids.size // 2))
            ids[draw.ints(0, ids.size - 1, k)] = \
                hubs[draw.ints(0, len(hubs) - 1, k)]
        trace.append(ids)
    return trace


def _differential(draw: Draw, faults: bool) -> None:
    csr = draw.csr(max_edges=1200)
    if csr.n_vertices == 0:
        return
    cache_kw = _hot_cache_kw(draw)
    decode = draw.choice(["host", "device"])
    trace = _zipf_trace(draw, csr.n_vertices, 3)
    inject = [k for k in (1, 4, 7) if draw.bool()] if faults else []
    with tempfile.TemporaryDirectory() as d:
        gp = os.path.join(d, "g.cbin")
        ref.paragrapher.save_graph(gp, csr, format="compbin")
        out = {}
        for side in SIDES:
            kw = dict(pgfuse_retries=3, pgfuse_retry_backoff_s=0.0) \
                if faults else {}
            with _open(side, gp, **kw) as g:
                inj = FaultyStorage()
                for k in inject:
                    inj.fail_at[k] = OSError(errno.EIO, "flaky OST")
                inj.install_graph(g)
                eng = side.query.NeighborQueryEngine(
                    g, decode=decode, **side.dev,
                    hotset=side.query.HotSetCache(**cache_kw, **(
                        side.dev if cache_kw["place"] == "device" else {})))
                answers = [eng.neighbors_batch(ids) for ids in trace]
                for ids, got in zip(trace, answers):
                    for v, nbrs in zip(ids, got):
                        assert nbrs.dtype == np.int64
                        np.testing.assert_array_equal(
                            nbrs, csr.neighbors_of(int(v)))
                assert eng.hotset.stats.conserved
                out[side.name] = (stats_ints(eng.stats),
                                  stats_ints(eng.hotset.stats),
                                  g.pgfuse_stats().retried_reads)
        assert out["port"] == out["ref"]


@prop(6)
def test_differential_hot_arm_port_ref_csr(draw: Draw):
    """Arbitrary graphs (empty rows, isolated vertices) and adversarial
    zipf traces: the port's hot engine == the reference's == the CSR,
    counters equal."""
    _differential(draw, faults=False)


@prop(4)
def test_differential_hot_arm_under_fault_injection(draw: Draw):
    """The same with spaced transient EIOs the retry policy absorbs."""
    _differential(draw, faults=True)
