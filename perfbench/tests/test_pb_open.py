"""The open-loop query cell rehearsed on the CPU at a small size
through the harness's own run, then with the answers or the submitter
broken underneath: each planted fault must turn ``correct`` false, and
a submitter that falls behind its schedule must show in the tail.

``BENCHMARK.json`` does not list the cell yet: on the card its
``query_p95_ms`` spreads by 14-42 % over six seeds at 0.6 and 0.7 of
the knee, because the engine's batches take every pending request
(PERF.md, Open questions).  The tests add it to a copy of the benchmark
as it will be listed, with the closed loops' engine metrics."""

import copy
import time

import numpy as np
import pytest

from perfbench import run

CELL = "query.g500-24.open"
#: the Graph500 graph at scale 10, a few warm-up requests, a rate the
#: CPU keeps up with
SMALL = {"config": {"scale": 10},
         "traffic": {"warmup_requests": 4, "rate_per_s": 40.0}}


#: the cell's entry as ``BENCHMARK.json`` will list it
WORKLOAD = {"name": CELL, "config": "g500-24", "traffic": "open-uniform",
            "chips": 1}


@pytest.fixture(scope="module")
def held(bench):
    """The benchmark with the open cell added: it reports every metric
    the uniform closed loop reports."""
    b = copy.deepcopy(bench)
    b["workloads"].append(dict(WORKLOAD))
    for m in b["end_to_end"] + b["per_layer"]:
        if "query.g500-24.uniform" in m.get("workloads", []):
            m["workloads"].append(CELL)
    return b


def execute(bench, trace=False, seed=20260011, seconds=1.0, updates=SMALL):
    return run.execute(bench, CELL, seed, seconds, trace, "cpu",
                       t_start=time.perf_counter(), updates=updates)


def test_the_open_cell_rehearses_on_the_cpu(held):
    out = execute(held)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"query_vertices_per_s", "query_p95_ms",
                                   "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["requests_checked"]["value"] >= 1
    traced = execute(held, trace=True, seed=20260012)
    assert traced["correct"], traced["checks"]
    # the closed loops' engine metrics read on the inherited context
    assert set(traced["metrics"]) == {
        "gather_ms.query", "fetch_ms.query", "storage_ms.query",
        "decode_ms.query", "hotset_ms.query", "hotset_hit_rate.query",
        "prefetch_ms.query", "queue_wait_p95_ms.query"}
    assert "breakdown" in traced and traced["device"]["window_s"] > 0


def test_the_arrivals_are_the_seeds_poisson_process(held):
    from perfbench.drivers import query_open
    _, cfg, traffic = run.cell_files(held, CELL, updates=SMALL)
    sent = []
    for seed in (20260013, 20260013, 20260014):
        cell = query_open.Cell(cfg, dict(traffic, rate_per_s=60.0), seed,
                               "cpu", False)
        try:
            cell.run(2.0)
            sent.append(np.diff(sorted(r[0] for r in cell.records)))
        finally:
            cell.release()
            cell.close()
    assert len(sent[0]) == len(sent[1]) and \
        np.allclose(sent[0], sent[1], rtol=0, atol=1e-9)
    assert len(sent[0]) != len(sent[2]) or \
        not np.allclose(sent[0], sent[2], rtol=0, atol=1e-9)
    # about 120 arrivals in 2 s at 60 / s (Poisson: sd ~11)
    assert all(70 <= len(s) <= 170 for s in sent), [len(s) for s in sent]


def test_a_late_submitter_counts_against_the_tail(held, monkeypatch):
    """Requests are timed from their scheduled arrival: a submit that
    takes 40 ms against a 20 ms mean gap puts the queue in the submitter
    and the tail grows with it."""
    from repro_torch.query.engine import NeighborQueryEngine
    base = execute(held, seed=20260015, seconds=1.5,
                   updates={**SMALL, "traffic": dict(SMALL["traffic"],
                                                     rate_per_s=50.0)})
    real = NeighborQueryEngine.submit

    def slow(self, vertices):
        time.sleep(0.04)
        return real(self, vertices)

    monkeypatch.setattr(NeighborQueryEngine, "submit", slow)
    late = execute(held, seed=20260015, seconds=1.5,
                   updates={**SMALL, "traffic": dict(SMALL["traffic"],
                                                     rate_per_s=50.0)})
    assert late["correct"]
    assert late["metrics"]["query_p95_ms"]["value"] > \
        max(300.0, 3 * base["metrics"]["query_p95_ms"]["value"])


def _patch_answers(monkeypatch, alter):
    from repro_torch.query.engine import NeighborQueryEngine
    real = NeighborQueryEngine.neighbors_batch

    def broken(self, vertices, **kw):
        return alter(real(self, vertices, **kw))

    monkeypatch.setattr(NeighborQueryEngine, "neighbors_batch", broken)


def test_an_altered_answer_fails(held, monkeypatch):
    def alter(res):
        for i, a in enumerate(res):
            if a.size:
                a = a.copy()
                a[0] ^= 1
                res[i] = a
                break
        return res

    _patch_answers(monkeypatch, alter)
    out = execute(held)
    assert not out["correct"] and out["checks"]["query_ids_wrong"]["value"] > 0


def test_reordered_answers_fail(held, monkeypatch):
    def alter(res):
        for i in range(len(res) - 1):
            if not np.array_equal(res[i], res[i + 1]):
                res[i], res[i + 1] = res[i + 1], res[i]
                break
        return res

    _patch_answers(monkeypatch, alter)
    out = execute(held)
    assert not out["correct"]


def test_failed_queries_fail(held, monkeypatch):
    def alter(res):
        raise OSError("planted storage error")

    _patch_answers(monkeypatch, alter)
    out = execute(held)
    assert not out["correct"] and out["failed"] > 0
    assert out["metrics"]["query_p95_ms"]["value"] is None   # infinite


def test_the_control_fails_where_the_program_passes(held):
    from perfbench import control
    r = control.readings(held, CELL, 20260016, 1.0, "cpu", updates=SMALL)
    assert r["program"]["correct"]
    others = [s for s in r if s != "program"]
    assert others and not any(r[s]["correct"] for s in others)


@pytest.mark.parametrize("key", ["rate_per_s", "ids_per_request",
                                 "check_share"])
def test_the_mix_states_its_rate_and_shape(held, key):
    _, _, traffic = run.cell_files(held, CELL)
    assert traffic["driver"] == "query_open" and traffic["hub_share"] == 0
    assert traffic[key] > 0
