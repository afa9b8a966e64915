"""The readers of the query engine's spans on hand-built span trees:
the fetch and hot-set self times and the prefetch's wall time a
micro-batch, the queue wait's p95, and what each reads where the spans
are absent (0) or the window has no micro-batch (None)."""

from types import SimpleNamespace

import pytest

from perfbench import run
from repro_torch.obs.trace import Span

READERS = ("fetch_ms.query", "hotset_ms.query", "prefetch_ms.query",
           "queue_wait_p95_ms.query")


def _span(name, tier, t0, t1, *children, **attrs):
    sp = Span(0, None, name, tier, t0, attrs)
    sp.t1 = t1
    sp.children = list(children)
    return sp


def _batch(t0, queued_s=None):
    """A 100 ms micro-batch: lookup 4, observe 1, offsets 20 (a 5 ms
    storage read inside), packed 30 (8 ms inside), decode 10, fill 5."""
    ms = lambda a, b: (t0 + a * 1e-3, t0 + b * 1e-3)
    attrs = {} if queued_s is None else {"queued_s": queued_s}
    return _span(
        "query.batch", "gather", *ms(0, 100),
        _span("query.hotset.lookup", "gather", *ms(1, 5), hits=2),
        _span("query.hotset.observe", "gather", *ms(5, 6)),
        _span("query.offsets", "gather", *ms(10, 30),
              _span("pgfuse.read", "storage", *ms(12, 17))),
        _span("query.packed", "gather", *ms(30, 60),
              _span("pgfuse.read", "storage", *ms(40, 48))),
        _span("query.decode", "decode", *ms(60, 70), bytes_h2d=0),
        _span("query.hotset.fill", "gather", *ms(70, 75)),
        **attrs)


def _ctx(spans):
    return SimpleNamespace(trace=None, counters={"spans": spans})


def _read(name, spans):
    return run.reader(name)(_ctx(spans))


def test_self_times_a_batch():
    spans = [_batch(0.0, [0.0]), _batch(1.0, [0.0])]
    assert _read("fetch_ms.query", spans) == pytest.approx(15 + 22)
    assert _read("hotset_ms.query", spans) == pytest.approx(4 + 1 + 5)
    # the gather tier is the fetch, the tier and the batch's own 30 ms
    gather = run.reader("gather_ms.query")(_ctx(spans))
    assert gather == pytest.approx(37 + 10 + 30)


def test_prefetch_is_its_roots_wall_time_a_batch():
    pre = _span("query.prefetch", "gather", 2.0, 2.03,
                _span("query.offsets", "gather", 2.0, 2.01))
    spans = [_batch(0.0), pre, _batch(1.0),
             _span("query.prefetch", "gather", 3.0, 3.05)]
    assert _read("prefetch_ms.query", spans) == pytest.approx((30 + 50) / 2)
    # a prefetch's fetch is not the batch's
    assert _read("fetch_ms.query", spans) == pytest.approx(37)


def test_queue_wait_is_the_nearest_rank_p95():
    waits = [i * 1e-3 for i in range(1, 41)]      # 1 .. 40 ms
    spans = [_batch(0.0, waits[:8]), _batch(1.0, waits[8:])]
    # rank ceil(0.95 * 40) = 38
    assert _read("queue_wait_p95_ms.query", spans) == pytest.approx(38.0)
    assert _read("queue_wait_p95_ms.query",
                 [_batch(0.0, [0.25])]) == pytest.approx(250.0)


def test_absent_spans_read_zero():
    """A micro-batch with none of the new spans (an older engine): each
    reader reports 0."""
    bare = _span("query.batch", "gather", 0.0, 0.1,
                 _span("query.decode", "decode", 0.02, 0.05))
    for name in READERS:
        assert _read(name, [bare]) == 0.0, name


@pytest.mark.parametrize("spans", [
    [], [_span("query.prefetch", "gather", 0.0, 0.1)],
    [_span("traversal.request", "request", 0.0, 1.0)]])
def test_no_batch_reads_none(spans):
    for name in READERS:
        assert _read(name, spans) is None, name
    empty = SimpleNamespace(trace=None, counters={})
    for name in READERS:
        assert run.reader(name)(empty) is None, name


@pytest.mark.parametrize("workload", ["query.g500-24.uniform",
                                      "query.g500-24.hubs"])
def test_query_cells_report_the_span_metrics(bench, workload):
    """A traced CPU rehearsal of each query cell reports the per-layer
    metrics ``test_pb_cells.LAYER`` pins and these four besides, with
    the fetch and the hot-set tier inside the gather tier."""
    from perfbench.tests.test_pb_cells import LAYER, execute
    out = execute(bench, workload, trace=True, seed=20260003)
    assert out["correct"], out["checks"]
    got = {k: m["value"] for k, m in out["metrics"].items()}
    assert set(got) == LAYER[workload] | set(READERS)
    assert all(got[name] >= 0 for name in READERS)
    assert got["queue_wait_p95_ms.query"] > 0
    assert (got["fetch_ms.query"] + got["hotset_ms.query"]
            <= got["gather_ms.query"] * (1 + 1e-9))
