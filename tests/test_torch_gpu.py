"""The port on a CUDA device: each kernel against its plain version, and
the call sites going through the kernels.  Every test here carries the
``gpu`` marker and skips where there is no card; run them on a GPU
machine with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py`` (the first test of each kernel builds it with
nvcc).  Integer results: tolerance ZERO (``torch.equal``); the segment
sum: f32 rtol 1e-5 / atol 1e-4, bf16 inputs 2e-2 / 2e-1 (atomics add in
no fixed order); flash attention: f32 2e-4, bf16 2e-2 (rtol and atol, the
JAX package's own kernel tolerances)."""

import numpy as np
import pytest
import torch

from repro_torch.core.paragrapher import open_graph, save_graph
from repro_torch.data import assemble_csr, stream_partitions
from repro_torch.graph import rmat
from repro_torch.kernels.compbin_decode import (compbin_decode,
                                                compbin_decode_ref)
from repro_torch.kernels.flash_attention import (attention_bshd,
                                                 attention_ref,
                                                 flash_attention)
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


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,Dh,causal", [
    (2, 4, 2, 256, 256, 64, True), (1, 8, 8, 128, 128, 128, True),
    (1, 4, 1, 1, 384, 64, True), (2, 6, 3, 100, 100, 64, True),
    (1, 2, 2, 64, 256, 64, True), (1, 2, 2, 128, 128, 64, False),
    (1, 15, 5, 64, 64, 64, True), (2, 12, 2, 300, 300, 128, True),
    (1, 4, 2, 40, 16, 64, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_equals_plain_version(cuda, B, Hq, Hkv, Sq,
                                                     Skv, Dh, causal, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(Sq + Skv)

    def t(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(cuda, dtype)
    q, k, v = t(B, Hq, Sq, Dh, scale=0.3), t(B, Hkv, Skv, Dh, scale=0.3), \
        t(B, Hkv, Skv, Dh)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and out.dtype == dtype
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), attention_ref(q, k, v,
                                                          causal=causal),
                               rtol=tol, atol=tol)
    if Sq > Skv:
        assert not out[:, :, :Sq - Skv].any()


def test_flash_attention_on_a_strided_cache_view(cuda):
    g = torch.Generator(device="cuda").manual_seed(0)
    cache = torch.randn(2, 2, 96, 5, 64, generator=g, device=cuda
                        ).to(torch.bfloat16)
    q = torch.randn(2, 3, 15, 64, generator=g, device=cuda
                    ).to(torch.bfloat16)
    k, v = cache[0, :, :71], cache[1, :, :71]
    out = attention_bshd(q, k, v, offset=68, kv_len=71)
    torch.cuda.synchronize()
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), offset=68, kv_len=71)
    torch.testing.assert_close(out.float(), want.transpose(1, 2),
                               rtol=2e-2, atol=2e-2)
    with pytest.raises(RuntimeError, match="no backward"):
        attention_bshd(q.float().requires_grad_(), k.float(), v.float())
    with pytest.raises(ValueError, match="Dh"):
        flash_attention(*(torch.zeros(1, 2, 4, 32, device=cuda),) * 3)


def test_lm_serving_goes_through_the_kernel(cuda):
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_arch("smollm-360m").make_config(),
                              n_layers=2, dtype=torch.float32)
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    before = flash_attention.launches
    tokens, t = serve_lm(cfg, batch=2, prompt_len=40, n_tokens=4,
                         params=params, keep_logits=True)
    assert flash_attention.launches - before == 2 * 4
    saved = tf.attention
    tf.attention = tf.attention_plain
    try:
        want_tokens, want = serve_lm(cfg, batch=2, prompt_len=40,
                                     n_tokens=4, params=params,
                                     keep_logits=True)
    finally:
        tf.attention = saved
    np.testing.assert_allclose(t["logits"], want["logits"], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(tokens, want_tokens)
