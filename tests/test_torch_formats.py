"""Wire formats: the port reads and writes the same bytes as the JAX
package.  The graph file is the state the two packages share, pinned by
``tests/golden``.  Integer data throughout: tolerance ZERO."""

import _torch_env  # noqa: F401  (first: one torch thread)
import io
import pathlib

import numpy as np
import pytest

from _torch_pair import (FORMATS, SUFFIX, as_csr, assert_csr_equal, encode,
                         port, ref)
from test_golden_formats import golden_graphs

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"


def _reader(side, fmt):
    return {"compbin": side.compbin.read_compbin,
            "webgraph": side.webgraph.read_webgraph,
            "logcsr": side.codec.read_logcsr}[fmt]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(golden_graphs()))
def test_port_parses_golden_fixture(name, fmt):
    want = golden_graphs()[name]
    blob = (GOLDEN_DIR / f"{name}.{SUFFIX[fmt]}").read_bytes()
    assert_csr_equal(_reader(port, fmt)(io.BytesIO(blob)), want)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(golden_graphs()))
def test_port_writer_reproduces_golden_bytes(name, fmt):
    g = golden_graphs()[name]
    blob = (GOLDEN_DIR / f"{name}.{SUFFIX[fmt]}").read_bytes()
    assert encode(port, g.offsets, g.neighbors, fmt) == blob


@pytest.fixture(scope="module")
def rmat_pair():
    a = ref.graph.rmat(10, 8, seed=11)
    b = port.graph.rmat(10, 8, seed=11)
    assert_csr_equal(a, b)          # same generator, same seed, same graph
    return a, b


@pytest.mark.parametrize("fmt", FORMATS)
def test_both_writers_emit_identical_bytes(rmat_pair, fmt):
    a, b = rmat_pair
    blob_ref = encode(ref, a.offsets, a.neighbors, fmt)
    blob_port = encode(port, b.offsets, b.neighbors, fmt)
    assert blob_ref == blob_port
    # and each side reads the other's file back to the same graph
    assert_csr_equal(_reader(port, fmt)(io.BytesIO(blob_ref)), a)
    assert_csr_equal(_reader(ref, fmt)(io.BytesIO(blob_port)), a)


@pytest.mark.parametrize("fmt", FORMATS)
def test_open_graph_agrees_on_detect_and_direct_reads(rmat_pair, fmt, tmp_path):
    a, _ = rmat_pair
    path = tmp_path / f"g.{SUFFIX[fmt]}"
    path.write_bytes(encode(port, a.offsets, a.neighbors, fmt))
    assert port.paragrapher.detect_format(path) == \
        ref.paragrapher.detect_format(path) == fmt
    with port.paragrapher.open_graph(path) as gp, \
            ref.paragrapher.open_graph(path) as gr:
        assert (gp.format, gp.n_vertices, gp.bytes_per_id) == \
            (gr.format, gr.n_vertices, gr.bytes_per_id)
        assert gp.partition_plan(5) == gr.partition_plan(5)
        for v in (0, 1, 17, a.n_vertices - 1):
            np.testing.assert_array_equal(gp.neighbors_of(v),
                                          gr.neighbors_of(v))
        v0, v1 = gp.partition_plan(5)[2]
        for x, y in zip(gp.read_partition(v0, v1), gr.read_partition(v0, v1)):
            np.testing.assert_array_equal(x, y)
        if fmt != "webgraph":
            for x, y in zip(gp.read_partition_raw(v0, v1),
                            gr.read_partition_raw(v0, v1)):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("k", range(0, 9))
def test_bytes_per_vertex_at_byte_fences(k):
    for n in {max(0, 2 ** (8 * k) - 1), 2 ** (8 * k), 2 ** (8 * k) + 1}:
        if n >= 2 ** 64:
            continue
        assert port.compbin.bytes_per_vertex(n) == \
            ref.compbin.bytes_per_vertex(n), n
    with pytest.raises(ValueError):
        port.compbin.bytes_per_vertex(-1)


@pytest.mark.parametrize("n_edges", [0, 1, 2, 255, 256, 2 ** 20, 2 ** 57,
                                     2 ** 58 - 1, 2 ** 62])
def test_logcsr_offset_bits_and_sizes_equal(n_edges):
    assert port.codec.offset_bits(n_edges) == ref.codec.offset_bits(n_edges)
    if n_edges <= 2 ** 20:
        for nv in (0, 1, 300, 70000):
            assert port.codec.logcsr_nbytes(nv, n_edges) == \
                ref.codec.logcsr_nbytes(nv, n_edges)
            assert port.compbin.compbin_nbytes(nv, n_edges) == \
                ref.compbin.compbin_nbytes(nv, n_edges)


def test_codec_registries_agree():
    assert sorted(port.codec.registered_codecs()) == \
        sorted(ref.codec.registered_codecs())
    assert port.codec.direct_codecs() == ref.codec.direct_codecs()
    for name, spec in ref.codec.registered_codecs().items():
        mine = port.codec.get_codec(name)
        assert (mine.magic, mine.suffix, mine.direct) == \
            (spec.magic, spec.suffix, spec.direct)
    with pytest.raises(ValueError):
        port.codec.get_codec("nope")


def test_port_csr_from_numpy_round_trip():
    g = golden_graphs()["six"]
    mine = as_csr(port, g.offsets.tolist(), g.neighbors)
    assert mine.offsets.dtype == np.int64
    assert mine.n_vertices == 6 and mine.n_edges == 12
    assert_csr_equal(mine, g)
