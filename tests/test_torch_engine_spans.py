"""The query engine's spans: fetch, hot-set tier, prefetch and queue wait.

A small rmat graph served by the port's engine (``device="cpu"``) with a
device-placed hot-set tier, a PG-Fuse mount small enough to miss, and an
injected :class:`~repro_torch.obs.Tracer` on a tick clock (integer
seconds, so every span sum below is exact).  The spans must nest under
``query.batch`` in tier ``gather``, their attributes must add up to the
tier's counters, the batch's ``gather`` self time must stay the batch
less its storage and decode, and while a ``torch.profiler`` session
records the spans must appear in its trace on the engine's worker
thread — and nothing at all without a tracer.
"""

import _torch_env  # noqa: F401  (first: one torch thread)
import itertools
import json
import os
import tempfile

import numpy as np
import pytest

from repro_torch.core.compbin import write_compbin
from repro_torch.core.paragrapher import open_graph
from repro_torch.graph import rmat
from repro_torch.obs import NULL_TRACER, Tracer, trace, verify_span_tree
from repro_torch.query import HotSetCache, NeighborQueryEngine

HOTSET = ("query.hotset.lookup", "query.hotset.observe",
          "query.hotset.fill")
FETCH = ("query.offsets", "query.packed")
ENGINE_SPANS = ("query.batch", "query.prefetch", "query.decode",
                *FETCH, *HOTSET)


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    csr = rmat(10, 8, seed=3)
    path = str(tmp_path_factory.mktemp("spans") / "g.cbin")
    write_compbin(path, csr)
    return path, np.diff(np.asarray(csr.offsets))


def _ticks():
    """A clock that advances one second a read."""
    c = itertools.count()
    return lambda: float(next(c))


def _batches(degrees, n=12, size=96, seed=0):
    """Id batches, half of each on the 32 top-degree vertices (so the
    tier hits, fills, evicts and prefetches)."""
    rng = np.random.default_rng(seed)
    hubs = np.argsort(-degrees, kind="stable")[:32]
    return [np.concatenate([rng.choice(hubs, size // 2),
                            rng.integers(0, degrees.size, size // 2)])
            for _ in range(n)]


def _engine(path, *, tracer=None, decode="host", clock=None):
    g = open_graph(path, use_pgfuse=True, pgfuse_block_size=4096,
                   pgfuse_max_resident_bytes=4 * 4096)
    hot = HotSetCache(budget_bytes=8 * 400, min_degree=2, place="device",
                      prefetch_min_hits=2, prefetch_batch=4, device="cpu")
    kw = {} if clock is None else {"clock": clock}
    eng = NeighborQueryEngine(g, decode=decode, hotset=hot, tracer=tracer,
                              device="cpu", **kw)
    return eng, g


def _traced_run(path, degrees, decode):
    clock = _ticks()
    tracer = Tracer(clock=clock, max_traces=1 << 16)
    eng, g = _engine(path, tracer=tracer, decode=decode, clock=clock)
    placed = []
    place = eng.hotset._place
    eng.hotset._place = lambda d: placed.append(d.size) or place(d)
    try:
        for vs in _batches(degrees):
            eng.neighbors_batch(vs)
        roots = tracer.drain()
        assert tracer.dropped_traces == 0
        return roots, eng.hotset.stats.as_dict(), len(placed)
    finally:
        eng.close()
        g.close()


def _all(roots, name):
    return [s for r in roots for s in r.iter_spans() if s.name == name]


@pytest.mark.parametrize("decode", ["host", "device"])
def test_spans_nest_under_the_batch_in_the_gather_tier(graph, decode):
    roots, _, _ = _traced_run(*graph, decode)
    batches = [r for r in roots if r.name == "query.batch"]
    assert len(batches) == 12
    assert {r.name for r in roots} == {"query.batch", "query.prefetch"}
    for r in roots:
        assert verify_span_tree(r) == [], r.name
        for s in r.iter_spans():
            assert s.name in ENGINE_SPANS or s.name == "pgfuse.read", s.name
            if s.name in FETCH + HOTSET:
                assert s.tier == "gather"
            if s.name == "pgfuse.read":
                # storage reads nest only in the fetch spans
                assert s.tier == "storage"
            for c in s.children:
                if c.name == "pgfuse.read":
                    assert s.name in FETCH, s.name
    for r in batches:
        assert [c.name for c in r.children if c.name in HOTSET] == \
            list(HOTSET)
        assert {c.name for c in r.children} <= \
            {"query.decode", *FETCH, *HOTSET}
    # every batch fetched something cold; the query.h2d marker is gone
    assert len(_all(batches, "query.offsets")) == 12
    assert not _all(roots, "query.h2d")
    for s in _all(roots, "query.offsets") + _all(roots, "query.packed"):
        assert s.attrs["reads"] >= 1
    decodes = _all(batches, "query.decode")
    assert all(s.attrs["mode"] == decode for s in decodes)
    shipped = sum(s.attrs["bytes_h2d"] for s in decodes)
    assert (shipped > 0) == (decode == "device")
    prefetches = [r for r in roots if r.name == "query.prefetch"]
    assert prefetches, "the hub traffic predicts no vertex"
    for r in prefetches:
        assert {c.name for c in r.children} >= \
            {"query.offsets", "query.packed", "query.decode",
             "query.hotset.fill"}


def _self(span_tree, pred):
    return sum(s.self_time_s for s in span_tree.iter_spans() if pred(s))


@pytest.mark.parametrize("decode", ["host", "device"])
def test_gather_self_time_is_the_batch_less_storage_and_decode(graph,
                                                               decode):
    roots, _, _ = _traced_run(*graph, decode)
    for r in (r for r in roots if r.name == "query.batch"):
        gather = _self(r, lambda s: s.tier == "gather")
        others = _self(r, lambda s: s.tier in ("storage", "decode", "h2d"))
        assert gather == pytest.approx(r.duration_s - others,
                                       rel=1e-12, abs=1e-12)
        fetch = _self(r, lambda s: s.name in FETCH)
        hot = _self(r, lambda s: s.name in HOTSET)
        assert fetch > 0 and hot > 0
        assert fetch + hot + r.self_time_s == pytest.approx(
            gather, rel=1e-12, abs=1e-12)


def test_hotset_attributes_add_up_to_the_tier_counters(graph):
    roots, st, placed = _traced_run(*graph, "host")
    lookups = _all(roots, "query.hotset.lookup")
    assert sum(s.attrs["hits"] for s in lookups) == st["hits"] > 0
    assert sum(s.attrs["misses"] for s in lookups) == st["misses"]
    # a device-placed tier copies every hit back alone
    assert sum(s.attrs["copies"] for s in lookups) == st["hits"]
    fills = _all(roots, "query.hotset.fill")
    assert sum(s.attrs["offered"] for s in fills) == st["fills"]
    assert sum(s.attrs["admitted"] for s in fills) == st["admitted"] > 0
    assert sum(s.attrs["evicted"] for s in fills) == st["evicted"] > 0
    assert sum(s.attrs["copies"] for s in fills) == placed > 0


def test_queued_s_has_one_entry_a_request(graph):
    path, degrees = graph
    tracer = Tracer(max_traces=1 << 16)
    eng, g = _engine(path, tracer=tracer)
    try:
        eng.neighbors_batch([1, 2, 3])
        futs = [eng.submit(vs[:16]) for vs in _batches(degrees, n=10)]
        for f in futs:
            f.result(timeout=60)
        eng.flush()
        batches = [r for r in tracer.drain() if r.name == "query.batch"]
    finally:
        eng.close()
        g.close()
    assert batches[0].attrs["queued_s"] == []     # a direct call
    queued = [q for r in batches[1:] for q in r.attrs["queued_s"]]
    assert len(queued) == len(futs)
    assert all(q >= 0 for q in queued)


def test_null_tracer_creates_no_span(graph, monkeypatch):
    path, degrees = graph
    made = []
    real = trace.Span.__init__

    def counted(self, *a, **kw):
        made.append(a)
        real(self, *a, **kw)

    monkeypatch.setattr(trace.Span, "__init__", counted)
    eng, g = _engine(path)
    try:
        assert eng._tracer is NULL_TRACER
        for vs in _batches(degrees, n=4):
            eng.neighbors_batch(vs)
        eng.submit([1, 2]).result(timeout=60)
        assert eng.hotset.stats.prefetch_fills > 0
    finally:
        eng.close()
        g.close()
    assert made == []
    assert NULL_TRACER.span("query.batch", tier="gather") is \
        NULL_TRACER.span("query.offsets", tier="gather")


def _all_threads_config():
    """``_ExperimentalConfig(profile_all_threads=True)``, or None where
    this PyTorch has no such field."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def _profiled_annotations(path, degrees, tracer):
    """(worker thread id, [(name, tid)] of the ``user_annotation``
    events) of requests sent to a running engine worker under an
    all-threads profiler."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _all_threads_config()
    if cfg is None:
        pytest.skip("this PyTorch's profiler has no profile_all_threads")
    eng, g = _engine(path, tracer=tracer)
    try:
        eng.submit([1, 2]).result(timeout=60)    # the worker is running
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=cfg) as prof:
            for vs in _batches(degrees, n=3):
                eng.submit(vs).result(timeout=60)
        worker = eng._worker.native_id
    finally:
        eng.close()
        g.close()
    fd, out = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(out)
        with open(out) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(out)
    return worker, [(e["name"], e.get("tid")) for e in events
                    if e.get("cat") == "user_annotation"]


def test_spans_are_profiler_ranges_on_the_worker_thread(graph):
    worker, ann = _profiled_annotations(*graph, Tracer(max_traces=1 << 16))
    names = {n for n, tid in ann if tid == worker}
    assert {"query.batch", "query.offsets", "query.packed", "query.decode",
            *HOTSET} <= names, names
    assert names <= set(ENGINE_SPANS) | {"pgfuse.read"}, names


def test_no_profiler_range_without_a_tracer(graph):
    _, ann = _profiled_annotations(*graph, None)
    assert not [n for n, _ in ann
                if n.startswith(("query.", "pgfuse."))], ann
