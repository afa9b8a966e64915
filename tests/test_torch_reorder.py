"""The graph compiler: the port's :mod:`repro_torch.graph.reorder` and
``repro_torch.launch.compile_graph`` against the JAX package's on the
same graphs.  Everything here is integer or bytes: orderings,
permutations, compiled ``.cbin`` / ``.lgsr`` files and GPRM sidecars
must be equal to the reference's byte for byte, and the CLI's JSON
report equal but for the paths."""

import _torch_env  # noqa: F401  (first: one torch thread)
import json
import os
import struct

import numpy as np
import pytest

from _torch_pair import assert_csr_equal, ref
from repro.graph import reorder as ref_reorder
from repro.launch.compile_graph import main as ref_main
from repro_torch.core import paragrapher, policy
from repro_torch.core.csr import csr_from_edges
from repro_torch.graph import reorder
from repro_torch.graph.generators import rmat
from repro_torch.launch.compile_graph import main
from tests._prop import Draw

CODECS = ("compbin", "logcsr")
STRATEGIES = (None, "bfs", "degree", "identity")


def _chain(n=8):
    """0-1-2-...-n-1 path plus a hub 0 touching everything."""
    src = np.concatenate([np.arange(n - 1), np.zeros(n - 1, np.int64)])
    dst = np.concatenate([np.arange(1, n), np.arange(1, n)])
    return csr_from_edges(src, dst, n, dedupe=True)


def _ref_csr(csr):
    return ref.csr.CSR(offsets=csr.offsets, neighbors=csr.neighbors)


# ---------------------------------------------------------------------------
# orderings and permutation plumbing: equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", reorder.ORDER_FNS)
@pytest.mark.parametrize("case", range(6))
def test_orders_equal_the_reference(strategy, case):
    draw = Draw(np.random.default_rng(1000 + case))
    nv = draw.int(1, 500)
    ne = draw.int(0, 2000)
    csr = csr_from_edges(draw.ints(0, nv - 1, ne),
                         draw.ints(0, nv - 1, ne), nv)
    perm = reorder.ORDER_FNS[strategy](csr)
    # a permutation of 0..n-1, computed deterministically
    np.testing.assert_array_equal(np.sort(perm), np.arange(nv))
    np.testing.assert_array_equal(perm, reorder.ORDER_FNS[strategy](csr))
    want = ref_reorder.ORDER_FNS[strategy](_ref_csr(csr))
    np.testing.assert_array_equal(perm, want)
    assert perm.dtype == want.dtype
    out = reorder.permute_csr(csr, perm)
    assert_csr_equal(out, ref_reorder.permute_csr(_ref_csr(csr), want))


def test_bfs_order_visits_levels_from_max_degree_root():
    np.testing.assert_array_equal(reorder.bfs_order(_chain(8)), np.arange(8))


def test_degree_order_puts_hubs_first():
    csr = _chain(8)
    perm = reorder.degree_order(csr)
    assert perm[0] == 0  # max-degree hub gets new id 0
    ranked = csr.degrees()[reorder.invert_permutation(perm)]
    assert (np.diff(ranked) <= 0).all()  # non-increasing by new id


def test_identity_order_is_identity():
    np.testing.assert_array_equal(reorder.identity_order(_chain(5)),
                                  np.arange(5))


def test_invert_permutation_validates():
    np.testing.assert_array_equal(
        reorder.invert_permutation(np.array([2, 0, 1])),
        np.array([1, 2, 0]))
    for bad, match in (([0, 3], "out of range"), ([-1, 0], "out of range"),
                       ([1, 1, 0], "duplicate")):
        with pytest.raises(ValueError, match=match):
            reorder.invert_permutation(np.array(bad))


def test_permute_csr_relabels_rows():
    csr = csr_from_edges(np.array([0, 0, 1]), np.array([1, 2, 2]), 3)
    perm = np.array([2, 0, 1])  # old 0 -> new 2
    out = reorder.permute_csr(csr, perm)
    np.testing.assert_array_equal(out.neighbors_of(2),  # old vertex 0
                                  np.sort(perm[csr.neighbors_of(0)]))
    np.testing.assert_array_equal(out.neighbors_of(0),  # old vertex 1
                                  np.sort(perm[csr.neighbors_of(1)]))
    with pytest.raises(ValueError, match="entries"):
        reorder.permute_csr(csr, np.array([0, 1]))


def test_map_back_restores_original_ids():
    old_of_new = np.array([3, 1, 0, 2])
    got = reorder.map_back(old_of_new, np.array([2, 0, 3]))
    np.testing.assert_array_equal(got, np.array([0, 2, 3]))
    assert got.dtype == np.int64


# ---------------------------------------------------------------------------
# the sidecar
# ---------------------------------------------------------------------------

def test_sidecar_roundtrip_and_bytes_equal_the_reference(tmp_path):
    path, rpath = str(tmp_path / "g.perm"), str(tmp_path / "r.perm")
    perm = np.random.default_rng(3).permutation(257).astype(np.int64)
    n = reorder.write_sidecar(path, perm)
    assert n == ref_reorder.write_sidecar(rpath, perm) == \
        os.path.getsize(path) == 16 + 8 * 257
    assert open(path, "rb").read() == open(rpath, "rb").read()
    np.testing.assert_array_equal(reorder.read_sidecar(rpath), perm)
    np.testing.assert_array_equal(ref_reorder.read_sidecar(path), perm)
    assert reorder.sidecar_path_for("out.lgsr") == "out.lgsr.perm"


def test_sidecar_rejects_corruption(tmp_path):
    path = str(tmp_path / "p.perm")
    reorder.write_sidecar(path, np.array([1, 0, 2]))
    blob = open(path, "rb").read()
    bad = str(tmp_path / "bad.perm")
    for data, err, match in (
            (b"NOPE" + blob[4:], ValueError, "magic"),
            (blob[:4] + struct.pack("<H", 9) + blob[6:], ValueError,
             "version"),
            (blob[:-8], IOError, "truncated"),
            (blob[:16] + struct.pack("<QQQ", 0, 0, 1), ValueError,
             "duplicate")):
        with open(bad, "wb") as f:
            f.write(data)
        with pytest.raises(err, match=match):
            reorder.read_sidecar(bad)
    with pytest.raises(ValueError):     # refuse to WRITE one too
        reorder.write_sidecar(bad, np.array([0, 0, 1]))


def test_choose_reorder_equals_the_reference():
    for nv, ne in ((100, 0), (0, 0), (1000, 400), (1000, 8000)):
        got, want = policy.choose_reorder(nv, ne), \
            ref.policy.choose_reorder(nv, ne)
        assert (got.strategy, got.reason) == (want.strategy, want.reason)
    assert policy.choose_reorder(1000, 8000).strategy == "bfs"
    for s in policy.REORDER_STRATEGIES:
        plan = policy.choose_reorder(1000, 8000, strategy=s)
        assert plan.strategy == s and "explicit" in plan.reason
    with pytest.raises(ValueError, match="unknown reorder strategy"):
        policy.choose_reorder(10, 10, strategy="sort-by-vibes")


# ---------------------------------------------------------------------------
# compile_graph end to end: the same bytes as the reference's compile
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def source(tmp_path_factory):
    d = tmp_path_factory.mktemp("compile")
    csr = rmat(scale=9, edge_factor=8, seed=4)
    src = str(d / "in.cbin")
    paragrapher.save_graph(src, csr, format="compbin")
    return src, csr


@pytest.mark.parametrize("codec_name", CODECS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_compiled_files_equal_the_reference(tmp_path, source, codec_name,
                                            strategy):
    src, csr = source
    out, rout = str(tmp_path / f"p.{codec_name}"), \
        str(tmp_path / f"r.{codec_name}")
    report = reorder.compile_graph(src, out, codec=codec_name,
                                   strategy=strategy, verify_samples=32)
    rreport = ref_reorder.compile_graph(src, rout, codec=codec_name,
                                        strategy=strategy, verify_samples=32)
    assert open(out, "rb").read() == open(rout, "rb").read()
    assert open(report.sidecar_path, "rb").read() == \
        open(rreport.sidecar_path, "rb").read()
    d, rd = report.as_dict(), rreport.as_dict()
    for key in ("in_path", "out_path", "sidecar_path"):
        d.pop(key), rd.pop(key)
    assert d == rd
    assert report.verified_vertices == 32
    assert report.out_bytes == os.path.getsize(out)
    if strategy is not None:
        assert report.strategy == strategy
    # the sidecar round-trips and inverse-maps every vertex
    old_of_new = reorder.read_sidecar(report.sidecar_path)
    new_of_old = reorder.invert_permutation(old_of_new)
    with paragrapher.open_graph(out) as g:
        assert g.n_vertices == csr.n_vertices
        for v in range(0, csr.n_vertices, 37):
            got = reorder.map_back(old_of_new,
                                   g.neighbors_of(int(new_of_old[v])))
            np.testing.assert_array_equal(
                got, np.sort(csr.neighbors_of(v).astype(np.int64)))


def test_compile_graph_refuses_bad_compile(tmp_path, monkeypatch):
    """If verification EVER fails the outputs must be removed."""
    csr = rmat(scale=7, edge_factor=6, seed=1)
    src = str(tmp_path / "in.cbin")
    paragrapher.save_graph(src, csr, format="compbin")
    out = str(tmp_path / "out.lgsr")

    def sabotage(old_of_new, new_ids):
        return np.asarray(new_ids, dtype=np.int64) + 1

    monkeypatch.setattr(reorder, "map_back", sabotage)
    with pytest.raises(AssertionError, match="diverged"):
        reorder.compile_graph(src, out, codec="logcsr", verify_samples=4)
    assert not os.path.exists(out)
    assert not os.path.exists(out + ".perm")


def test_compile_graph_cli_report_equals_the_reference(tmp_path, capsys):
    csr = rmat(scale=8, edge_factor=6, seed=9)
    src = str(tmp_path / "in.cbin")
    paragrapher.save_graph(src, csr, format="compbin")
    reports = []
    for fn, stem in ((main, "p"), (ref_main, "r")):
        out = str(tmp_path / f"{stem}.lgsr")
        rc = fn(["--in", src, "--out", out, "--codec", "logcsr",
                 "--strategy", "bfs", "--verify-samples", "16"])
        assert rc == 0
        reports.append(json.loads(capsys.readouterr().out))
        assert os.path.exists(out) and os.path.exists(out + ".perm")
    got, want = reports
    assert got["codec"] == "logcsr" and got["strategy"] == "bfs"
    assert got["verified_vertices"] == 16
    assert set(got) == set(want)
    for key in want:
        if key.endswith("path"):
            assert os.path.basename(got[key])[1:] == \
                os.path.basename(want[key])[1:]
        else:
            assert got[key] == want[key], key
