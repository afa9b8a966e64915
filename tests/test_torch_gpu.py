"""The port on a CUDA device: each kernel against its plain version, and
the call sites going through the kernels.  Every test here carries the
``gpu`` marker and skips where there is no card; run them on a GPU
machine with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py`` (the first test of each kernel builds it with
nvcc).  Integer results: tolerance ZERO (``torch.equal``); the segment
sum: f32 rtol 1e-5 / atol 1e-4, bf16 inputs 2e-2 / 2e-1 (atomics add in
no fixed order)."""

import numpy as np
import pytest
import torch

from repro_torch.core.paragrapher import open_graph, save_graph
from repro_torch.data import assemble_csr, stream_partitions
from repro_torch.graph import rmat
from repro_torch.kernels.compbin_decode import (compbin_decode,
                                                compbin_decode_ref)
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_ref
from repro_torch.query import NeighborQueryEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("b", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 127, 128, 1000, 40000])
def test_kernel_equals_plain_version(cuda, b, n):
    rng = np.random.default_rng(b * 1000 + n)
    packed = torch.from_numpy(
        rng.integers(0, 256, n * b, dtype=np.uint8)).to(cuda)
    before = compbin_decode.launches
    out = compbin_decode(packed, b)
    torch.cuda.synchronize()
    assert compbin_decode.launches == before + 1
    assert torch.equal(out, compbin_decode_ref(packed, b))
    # a base pointer off the 4-byte grid takes the byte-wise path
    view = torch.cat([packed[:1], packed])[1:]
    assert view.data_ptr() % 4 == 1
    assert torch.equal(compbin_decode(view, b), compbin_decode_ref(view, b))


def test_load_and_serve_go_through_the_kernel(cuda, tmp_path):
    csr = rmat(12, 8, seed=1)
    path = str(tmp_path / "g.cbin")
    save_graph(path, csr)
    before = compbin_decode.launches
    with open_graph(path, use_pgfuse=True) as g:
        with stream_partitions(g) as stream:       # device=None -> the GPU
            shards = list(stream)
        assert all(s.neighbors.is_cuda for s in shards)
        assert compbin_decode.launches == before + len(shards)
        assert assemble_csr(shards) == csr
        assert stream.stats.host_decode_bytes == 0
        with NeighborQueryEngine(g, decode="device") as eng:
            vs = np.arange(0, csr.n_vertices, 3)
            for v, got in zip(vs, eng.neighbors_batch(vs)):
                np.testing.assert_array_equal(got, csr.neighbors_of(v))
            assert eng.stats.device_batches == 1
        assert compbin_decode.launches == before + len(shards) + 1


@pytest.mark.parametrize("E,D,N", [(64, 16, 4), (513, 200, 7),
                                   (2048, 128, 1024), (100, 1, 100),
                                   (1, 8, 1), (30720, 1433, 31744)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_kernel_equals_plain_version(cuda, E, D, N, dtype):
    rng = np.random.default_rng(E + D + N)
    msgs = torch.from_numpy(
        rng.standard_normal((E, D)).astype(np.float32)).to(cuda, dtype)
    ids = torch.from_numpy(rng.integers(-1, N + 2, E).astype(np.int32)
                           ).to(cuda)
    before = segment_sum.launches
    out = segment_sum(msgs, ids, N)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (N, D)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out, segment_sum_ref(msgs, ids, N),
                               rtol=tol, atol=tol * 10)
    assert not segment_sum(msgs[:0], ids[:0], N).any()
    with pytest.raises(RuntimeError, match="no backward"):
        segment_sum(msgs.detach().float().requires_grad_(), ids, N)


def test_gcn_serving_goes_through_both_kernels(cuda, tmp_path):
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import make_gnn_server

    cfg = get_arch("gcn-cora").make_reduced()
    k1, k2 = compbin_decode.launches, segment_sum.launches
    answer, engine, close = make_gnn_server(
        "gcn-cora", cfg, str(tmp_path), fanouts=(5, 5), decode="device")
    try:
        logits = answer(np.arange(64))
    finally:
        close()
    assert logits.shape == (64, cfg.n_classes) and np.isfinite(logits).all()
    assert compbin_decode.launches - k1 == engine.stats.device_batches > 0
    assert segment_sum.launches - k2 == cfg.n_layers + 1
