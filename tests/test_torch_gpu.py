"""The port on a CUDA device: kernel against its plain version, and the
two call sites going through the kernel.  Every test here carries the
``gpu`` marker and skips where there is no card; run them on a GPU
machine with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py`` (the first test builds the kernel with nvcc).
Integer results: tolerance ZERO (``torch.equal``)."""

import numpy as np
import pytest
import torch

from repro_torch.core.paragrapher import open_graph, save_graph
from repro_torch.data import assemble_csr, stream_partitions
from repro_torch.graph import rmat
from repro_torch.kernels.compbin_decode import (compbin_decode,
                                                compbin_decode_ref)
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
