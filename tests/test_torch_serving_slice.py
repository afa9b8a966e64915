"""The serving stack's phases of ``chip_smoke.py`` — the hot-set tier and
the traversal service on one engine and on 2 shards x 2 replicas — run
here with ``device="cpu"`` on a scale-10 graph, so what the GPU run
drives is what these tests ran; and every check those phases make is
shown to fail on a planted fault (a flipped neighbor id in a hot answer,
a dropped vertex in a k-hop set, a wrong path, a launch counted off the
books, torn hot-set books, a kind that never completes).  The phases'
plain numpy traversal is held to the pure-python CSR reference of
``tests/test_traversal_differential.py`` first."""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest

from repro_torch.kernels.compbin_decode import compbin_decode
from repro_torch.query import (HotSetCache, HotSetStats,
                               NeighborQueryEngine, TraversalService,
                               TraversalShed)
from tests._prop import Draw, prop
from tests.test_traversal_differential import ref_traverse

ROOT = pathlib.Path(__file__).resolve().parent.parent


_SMOKE = []


def _load_smoke():
    """``chip_smoke.py`` as a module, loaded once."""
    if not _SMOKE:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", ROOT / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        path_before = list(sys.path)
        try:
            spec.loader.exec_module(mod)
        finally:
            sys.path[:] = path_before
        _SMOKE.append(mod)
    return _SMOKE[0]


@pytest.fixture(scope="module")
def smoke():
    return _load_smoke()


@pytest.fixture(scope="module")
def small(smoke, tmp_path_factory):
    csr, path, _, _ = smoke.make_graph(10, str(tmp_path_factory.mktemp("s")))
    return csr, path


#: one-at-a-time requests by kind: unequal, so the quota is exercised
SEQUENTIAL = {"khop": 3, "bfs": 2, "path": 1}
TRAVERSAL_ARMS = {"one_engine": {},
                  "sharded": dict(shards=2, replication=2,
                                  hotset_bytes=1 << 16)}


def _hot(smoke, small):
    csr, path = small
    return smoke.phase_hotset(csr, path, "cpu", n_batches=8, batch=1024)


def _trav(smoke, small, arm):
    csr, path = small
    return smoke.phase_traversal(csr, path, "cpu", sequential=SEQUENTIAL,
                                 n_concurrent=6, batch=8,
                                 **TRAVERSAL_ARMS[arm])


def test_hotset_phase_on_cpu(smoke, small):
    out = _hot(smoke, small)
    hs = out["hot"]["hotset"]
    assert hs["hits"] > 0 and hs["resident_entries"] > 0
    assert hs["resident_bytes"] <= out["budget_bytes"]
    assert out["cold"]["launches"] == out["hot"]["launches"] == 0
    assert out["cold"]["device_batches"] > 0          # decode="auto"
    assert out["cold"]["ids_checked"] == out["hot"]["ids_checked"] > 0
    assert out["hubs"] == 16 and out["budget_bytes"] >= 1 << 16


@pytest.mark.parametrize("arm", sorted(TRAVERSAL_ARMS))
def test_traversal_phase_on_cpu(smoke, small, arm):
    out = _trav(smoke, small, arm)
    assert out["completed"] == 12 and out["shed"] == 0
    assert {k: v["n"] for k, v in out["per_kind"].items()} == SEQUENTIAL
    for v in out["per_kind"].values():      # too few for a p99
        assert v["p99_s"] is None and v["max_s"] >= v["p50_s"]
    assert out["launches"] == 0 and out["vertices_checked"] > 0
    assert out["frontier_batches"] > 0 and out["executor_threads"] >= 1
    assert ("router" in out) == (arm == "sharded")
    assert ("hotset" in out) == (arm == "sharded")


@prop(8)
def test_plain_traverse_equals_the_csr_reference(draw: Draw):
    """The phases' numpy traversal reproduces the pure-python reference
    on arbitrary graphs, seeds and budgets, every field."""
    plain_traverse = _load_smoke().plain_traverse
    csr = draw.csr(max_edges=800)
    if csr.n_vertices == 0:
        return
    for _ in range(4):
        seeds = draw.vertex_batch(csr.n_vertices, max_size=12)
        if seeds.size == 0:
            continue
        kind = draw.choice(["khop", "bfs", "path"])
        kw = dict(max_edges=draw.choice([1 << 20,
                                         draw.int(0, max(1, csr.n_edges))]))
        if kind == "path":
            seeds = seeds[:1]
            kw["target"] = draw.int(0, csr.n_vertices - 1)
            kw["k"] = None if draw.bool() else draw.int(0, 3)
        else:
            kw["k"] = draw.int(0, 3) if kind == "khop" or draw.bool() \
                else None
            if draw.bool():
                kw["max_vertices"] = draw.int(1, csr.n_vertices)
        got = plain_traverse(csr, kind, seeds, **kw)
        want = ref_traverse(csr, kind, seeds, **kw)
        assert got["vertices"].tolist() == want["vertices"]
        assert got["depths"].tolist() == want["depths"]
        for key in ("found", "path", "truncated", "hops", "edges_scanned"):
            assert got[key] == want[key], key


# -- planted faults: each check of the new phases must be able to fail ----

def test_hotset_phase_catches_a_flipped_hot_answer(smoke, small,
                                                   monkeypatch):
    fetch = HotSetCache._fetch

    def flipped(entry):
        a = fetch(entry)
        a[0] ^= 1
        return a

    monkeypatch.setattr(HotSetCache, "_fetch", staticmethod(flipped))
    with pytest.raises(AssertionError, match="neighbor ids differ"):
        _hot(smoke, small)


def test_hotset_phase_catches_runs_off_the_device(smoke, small,
                                                  monkeypatch):
    """A tier asked to place on the device that keeps host arrays still
    answers right; the phase must refuse it all the same."""
    monkeypatch.setattr(HotSetCache, "_place",
                        lambda self, decoded: decoded.astype(np.int64))
    with pytest.raises(AssertionError, match="resident runs are not on"):
        _hot(smoke, small)


def _count_off_the_books(monkeypatch):
    decode = NeighborQueryEngine._decode_device

    def counted(self, packed):
        compbin_decode.launches += 1
        return decode(self, packed)

    monkeypatch.setattr(NeighborQueryEngine, "_decode_device", counted)


def test_hotset_phase_catches_a_launch_off_the_books(smoke, small,
                                                     monkeypatch):
    _count_off_the_books(monkeypatch)
    with pytest.raises(AssertionError):
        _hot(smoke, small)


def test_hotset_phase_catches_torn_hotset_books(smoke, small, monkeypatch):
    as_dict = HotSetStats.as_dict

    def torn(self):
        d = as_dict(self)
        d["hits"] += 1
        return d

    monkeypatch.setattr(HotSetStats, "as_dict", torn)
    with pytest.raises(AssertionError):
        _hot(smoke, small)


def _plant(monkeypatch, kind, damage):
    traverse = TraversalService._traverse

    def planted(self, req):
        res = traverse(self, req)
        if req.kind == kind:
            damage(res)
        return res

    monkeypatch.setattr(TraversalService, "_traverse", planted)


@pytest.mark.parametrize("arm", sorted(TRAVERSAL_ARMS))
def test_traversal_phase_catches_a_dropped_khop_vertex(smoke, small,
                                                       monkeypatch, arm):
    def drop(res):
        res.vertices, res.depths = res.vertices[:-1], res.depths[:-1]

    _plant(monkeypatch, "khop", drop)
    with pytest.raises(AssertionError, match="khop: visit set differs"):
        _trav(smoke, small, arm)


def test_traversal_phase_catches_a_wrong_path(smoke, small, monkeypatch):
    def damage(res):
        res.found = True
        res.path = np.zeros(1 if res.path is None else res.path.size + 1,
                            np.int64)

    _plant(monkeypatch, "path", damage)
    with pytest.raises(AssertionError, match="path: found differs|"
                                             "path: path length differs"):
        _trav(smoke, small, "one_engine")


def test_traversal_phase_catches_a_wrong_bfs_depth(smoke, small,
                                                   monkeypatch):
    def damage(res):
        res.depths = res.depths + 1

    _plant(monkeypatch, "bfs", damage)
    with pytest.raises(AssertionError, match="bfs: depths differ"):
        _trav(smoke, small, "one_engine")


@pytest.mark.parametrize("arm", sorted(TRAVERSAL_ARMS))
def test_traversal_phase_catches_a_launch_off_the_books(smoke, small,
                                                        monkeypatch, arm):
    _count_off_the_books(monkeypatch)
    with pytest.raises(AssertionError):
        _trav(smoke, small, arm)


def test_traversal_phase_needs_every_kind_to_complete(smoke, small,
                                                      monkeypatch):
    request = TraversalService.request

    def shed_paths(self, req):
        if req.kind == "path":
            raise TraversalShed("planted")
        return request(self, req)

    monkeypatch.setattr(TraversalService, "request", shed_paths)
    with pytest.raises(AssertionError, match="'path': 0"):
        _trav(smoke, small, "one_engine")
