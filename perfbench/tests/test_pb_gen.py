"""The benchmark's inputs: the frozen CompBin writer and the device
Kronecker generator."""

import io

import numpy as np
import pytest
import torch

from perfbench.gen import compbin, kronecker

GOLDEN = __import__("pathlib").Path(__file__).resolve().parents[2] \
    / "tests" / "golden"


def golden_graphs() -> dict:
    """The literal graphs behind ``tests/golden/*.cbin`` (as
    ``tests/test_golden_formats.py`` states them)."""
    six = (np.array([0, 2, 5, 5, 6, 11, 12]),
           np.array([1, 3, 0, 2, 5, 4, 0, 1, 2, 3, 5, 2]))
    empty = (np.zeros(1, np.int64), np.zeros(0, np.int32))
    offs = np.zeros(301, dtype=np.int64)
    offs[1:151] = 2
    offs[151:300] = 4
    offs[300] = 5
    fence = (offs, np.array([150, 299, 0, 299, 150]))
    return {"six": six, "empty": empty, "fence300": fence}


@pytest.mark.parametrize("name", sorted(golden_graphs()))
def test_writer_reproduces_the_golden_files(name):
    offsets, neighbors = golden_graphs()[name]
    buf = io.BytesIO()
    n = compbin.write(buf, torch.as_tensor(offsets), torch.as_tensor(neighbors))
    want = (GOLDEN / f"{name}.cbin").read_bytes()
    assert buf.getvalue() == want
    assert n == len(want)


def test_writer_writes_a_path(tmp_path):
    offsets, neighbors = golden_graphs()["fence300"]
    p = tmp_path / "g.cbin"
    compbin.write(p, torch.as_tensor(offsets), torch.as_tensor(neighbors))
    assert p.read_bytes() == (GOLDEN / "fence300.cbin").read_bytes()


@pytest.mark.parametrize("n, b", [(1, 1), (256, 1), (257, 2), (1 << 16, 2),
                                  ((1 << 16) + 1, 3), (1 << 24, 3),
                                  ((1 << 24) + 1, 4)])
def test_bytes_per_id(n, b):
    assert compbin.bytes_per_id(n) == b


def test_generator_repeats_for_a_seed_and_changes_with_another():
    a = kronecker.graph500_csr(9, 16, 12345678901, "cpu")
    b = kronecker.graph500_csr(9, 16, 12345678901, "cpu")
    c = kronecker.graph500_csr(9, 16, 12345678902, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not (a[0].shape == c[0].shape and torch.equal(a[0], c[0])
                and a[1].shape == c[1].shape and torch.equal(a[1], c[1]))


def test_generator_csr_is_sorted_deduplicated_and_skewed():
    offsets, neighbors = kronecker.graph500_csr(10, 16, 7, "cpu")
    n = 1 << 10
    assert offsets.shape == (n + 1,) and offsets[0] == 0
    assert neighbors.dtype == torch.int32
    assert int(offsets[-1]) == neighbors.numel() <= 16 * n
    assert neighbors.numel() > 0.6 * 16 * n   # duplicates dropped
    rows = torch.repeat_interleave(torch.arange(n), offsets.diff())
    key = rows * n + neighbors.long()
    assert bool((key[1:] > key[:-1]).all())          # sorted, no duplicates
    deg = offsets.diff()
    assert int(deg.max()) > 20 * float(deg.float().mean())   # Kronecker hubs


def test_bounded_edges_stay_in_range_and_repeat():
    s, d = kronecker.bounded_edges(700, 5000, 10, 99, "cpu")
    s2, d2 = kronecker.bounded_edges(700, 5000, 10, 99, "cpu")
    assert s.shape == d.shape == (5000,)
    assert int(s.max()) < 700 and int(d.max()) < 700 and int(s.min()) >= 0
    assert torch.equal(s, s2) and torch.equal(d, d2)
    with pytest.raises(ValueError):
        kronecker.bounded_edges(2000, 10, 10, 1, "cpu")


def test_pack_ids_is_little_endian():
    got = compbin.pack_ids(torch.tensor([0x010203, 5]), 3)
    assert got.tolist() == [3, 2, 1, 5, 0, 0]


def test_a_fixed_structure_gives_isomorphic_graphs_under_other_labels():
    a = kronecker.graph500_csr(9, 16, 1, "cpu", structure_seed=0)
    b = kronecker.graph500_csr(9, 16, 2, "cpu", structure_seed=0)
    assert a[1].numel() == b[1].numel()
    assert not torch.equal(a[1], b[1])
    assert torch.equal(a[0].diff().sort().values, b[0].diff().sort().values)


def test_gcn_weights_repeat_for_a_seed_in_their_plain_shapes():
    from perfbench.gen import weights
    a = weights.gcn_params(100, 16, 47, 2**31 + 7, "cpu")
    b = weights.gcn_params(100, 16, 47, 2**31 + 7, "cpu")
    c = weights.gcn_params(100, 16, 47, 2**31 + 8, "cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "w0": (100, 16), "b0": (16,), "w1": (16, 47), "b1": (47,)}
    assert all(v.dtype == torch.float32 for v in a.values())
    assert not a["b0"].any() and not a["b1"].any()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["w0"], c["w0"])
    # truncated at two standard deviations of 1 / sqrt(fan-in)
    assert float(a["w0"].abs().max()) <= 2 * 100 ** -0.5 + 1e-6
    assert 0.7 < float(a["w0"].std() * 10) < 1.0


def test_gcn_batch_is_symmetric_with_each_inverse_after_its_edge():
    from types import SimpleNamespace

    from perfbench.drivers.train import make_batch
    cfg = {"n_nodes": 600, "n_edges": 4000, "n_classes": 5,
           "train_nodes": 100, "edges": {"scale": 10, "seed": 0}}
    meta = lambda *s, dt=torch.int32: SimpleNamespace(shape=s, dtype=dt)
    specs = {"edge_src": meta(4100), "edge_dst": meta(4100),
             "x": meta(640, 8), "labels": meta(640)}
    b = make_batch(cfg, specs, 5, "cpu")
    src, dst = b["edge_src"], b["edge_dst"]
    assert bool((src[4000:] == -1).all() and (dst[4000:] == -1).all())
    assert torch.equal(src[0:4000:2], dst[1:4000:2])
    assert torch.equal(dst[0:4000:2], src[1:4000:2])
    assert int(src[:4000].max()) < 600 and int(src[:4000].min()) >= 0
    with pytest.raises(ValueError):
        make_batch(dict(cfg, n_edges=3999), specs, 5, "cpu")
