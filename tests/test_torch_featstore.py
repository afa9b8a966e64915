"""The feature store: the port's writer reproduces the golden ``.fst``
files byte for byte, both packages write the same bytes for the same
matrix, and rows read through either package's reader (plain file or
PG-Fuse mount) and ``gather_rows`` are equal.  Tolerance ZERO."""

import _torch_env  # noqa: F401  (first: one torch thread)
import dataclasses
import io
import pathlib

import numpy as np
import pytest

from repro.core import featstore as ref_fst
from repro.core import pgfuse as ref_pgfuse
from repro.graph import features as ref_features
from repro.query.engine import gather_rows as ref_gather_rows
from repro_torch.core import featstore as port_fst
from repro_torch.core import pgfuse as port_pgfuse
from repro_torch.graph import features as port_features
from repro_torch.query.engine import gather_rows as port_gather_rows

GOLDEN = pathlib.Path(__file__).parent / "golden"


def _golden_features() -> dict:
    """The literal matrices the goldens were written from (the JAX
    package's ``tests/test_golden_formats.py::golden_features``)."""
    f32 = np.array([[0.0, 0.5, -1.25], [2.0, -0.75, 3.5], [1.0, 0.0, -2.0],
                    [0.25, 4.0, -0.5], [-3.0, 0.125, 1.5]], dtype=np.float32)
    f16 = np.array([[1.0, -0.5], [0.25, 2.0], [-4.0, 0.0], [0.5, -1.5]],
                   dtype=np.float16)
    return {"feat5x3": (f32, 64),
            "feat4x2h": (f16, 128),
            "featempty": (np.zeros((0, 7), dtype=np.float32), 64),
            "feat2x3u8": (np.array([[0, 1, 255], [128, 64, 32]],
                                   dtype=np.uint8), 64)}


@pytest.mark.parametrize("name", sorted(_golden_features()))
def test_writer_reproduces_golden_bytes(name):
    x, align = _golden_features()[name]
    want = (GOLDEN / f"{name}.fst").read_bytes()
    assert port_fst.roundtrip_bytes(x, data_align=align) == want
    got = port_fst.read_featstore(io.BytesIO(want))
    assert got.dtype == x.dtype and np.array_equal(got, x)
    assert dataclasses.astuple(port_fst.read_header(io.BytesIO(want))) == \
        dataclasses.astuple(ref_fst.read_header(io.BytesIO(want)))


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.uint8])
@pytest.mark.parametrize("align", [1, 64, 4096])
def test_both_packages_write_the_same_bytes(dtype, align):
    rng = np.random.default_rng(align)
    x = (rng.standard_normal((37, 11)) * 50).astype(dtype)
    blob = port_fst.roundtrip_bytes(x, data_align=align)
    assert blob == ref_fst.roundtrip_bytes(x, data_align=align)
    assert len(blob) == port_fst.featstore_nbytes(37, 11, dtype,
                                                  data_align=align)


def test_reader_errors_match(tmp_path):
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    blob = port_fst.roundtrip_bytes(x)
    with pytest.raises(ValueError, match="bad magic"):
        port_fst.read_header(io.BytesIO(b"XXXX" + blob[4:]))
    with pytest.raises(ValueError, match="truncated"):
        port_fst.read_header(io.BytesIO(blob[:10]))
    with pytest.raises(IOError, match="short read"):
        port_fst.FeatStoreFile(io.BytesIO(blob[:-4])).read_rows(0, 4)
    with pytest.raises(ValueError, match="bad row range"):
        port_fst.FeatStoreFile(io.BytesIO(blob)).read_rows(3, 5)
    with pytest.raises(ValueError, match="2-D"):
        port_fst.write_featstore(str(tmp_path / "a.fst"), x[0])


@pytest.mark.parametrize("mounted", [False, True])
def test_rows_and_gather_match_the_reference(tmp_path, mounted):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3000, 24)).astype(np.float32)
    path = str(tmp_path / "x.fst")
    port_fst.write_featstore(path, x, data_align=1 << 12)
    ids = rng.integers(-1, 3000, 500)
    out = {}
    for side, fst, fs_mod, gather in (
            ("ref", ref_fst, ref_pgfuse, ref_gather_rows),
            ("port", port_fst, port_pgfuse, port_gather_rows)):
        fs = fs_mod.PGFuseFS(block_size=1 << 12) if mounted else None
        with fst.open_featstore(path, fs=fs) as h:
            assert (h.n_rows, h.d, h.dtype) == (3000, 24, np.float32)
            rows = h.read_rows(100, 400)
            got = gather(h, ids)
            st = h.pgfuse_stats()
        if fs is not None:
            fs.unmount()
        out[side] = (rows, got, st)
    np.testing.assert_array_equal(out["port"][0], x[100:400])
    np.testing.assert_array_equal(out["port"][1], out["ref"][1])
    want = np.where((ids >= 0)[:, None], x[np.maximum(ids, 0)], 0)
    np.testing.assert_array_equal(out["port"][1], want)
    if mounted:
        p, r = out["port"][2], out["ref"][2]
        assert (p.cache_hits, p.cache_misses, p.underlying_bytes) == \
            (r.cache_hits, r.cache_misses, r.underlying_bytes)
    else:
        assert out["port"][2] is None


def test_graph_converters_write_the_same_files(tmp_path):
    from repro.core import paragrapher as ref_pg
    from repro.graph import rmat

    gp = str(tmp_path / "g.cbin")
    ref_pg.save_graph(gp, rmat(8, 4, seed=2))
    for fn, args in (("featstore_for_graph", (12,)),
                     ("labelstore_for_graph", (5,))):
        blobs = []
        for side, mod in (("ref", ref_features), ("port", port_features)):
            out = str(tmp_path / f"{fn}_{side}.fst")
            getattr(mod, fn)(gp, out, *args, seed=3, data_align=256)
            blobs.append(pathlib.Path(out).read_bytes())
        assert blobs[0] == blobs[1], fn
    x = port_features.synthesize_node_features(50, 9, seed=1)
    np.testing.assert_array_equal(
        x, ref_features.synthesize_node_features(50, 9, seed=1))
    np.testing.assert_array_equal(
        port_features.synthesize_separable_labels(x, 6, seed=2),
        ref_features.synthesize_separable_labels(x, 6, seed=2))


def test_bfloat16_rows_match_the_reference_without_ml_dtypes(tmp_path):
    """Code 2 (bfloat16): the port holds the rows as raw 16-bit patterns
    (``BF16_BITS``, no ``ml_dtypes``); the bytes it writes equal the JAX
    package's for the same values, each package reads the other's file,
    and ``rows_to_tensor`` views them as ``torch.bfloat16``."""
    import ml_dtypes
    import torch

    x = np.random.default_rng(4).standard_normal((6, 5)).astype(
        ml_dtypes.bfloat16)
    bits = x.view(np.uint16).view(port_fst.BF16_BITS)
    ref_buf, port_buf = io.BytesIO(), io.BytesIO()
    ref_fst.write_featstore(ref_buf, x, data_align=64)
    port_fst.write_featstore(port_buf, bits, data_align=64)
    assert port_buf.getvalue() == ref_buf.getvalue()
    assert port_fst.dtype_code(port_fst.BF16_BITS) == 2
    p = tmp_path / "bf16.fst"
    p.write_bytes(ref_buf.getvalue())
    got = port_fst.read_featstore(str(p))
    assert got.dtype == port_fst.BF16_BITS and got.shape == (6, 5)
    np.testing.assert_array_equal(got.view(np.uint16), x.view(np.uint16))
    t = port_fst.rows_to_tensor(got)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))
