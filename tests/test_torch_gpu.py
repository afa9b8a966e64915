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
                                                 flash_attention, plan)
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


def _bf16(rng, *shape, scale=1.0, device="cuda"):
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(device, torch.bfloat16)


@pytest.mark.parametrize("Sq", [63, 64, 65, 100, 128, 129, 300, 1024])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_tc_prefill_across_its_tile_edges(cuda, Sq, Dh, causal):
    """bf16 prefill on the tensor cores: row counts either side of the
    64-row warpgroup and 128-row block, key counts off the 64-key tile."""
    rng = np.random.default_rng(Sq * Dh + causal)
    q = _bf16(rng, 1, 2, Sq, Dh, scale=0.3)
    k, v = _bf16(rng, 1, 2, Sq, Dh, scale=0.3), _bf16(rng, 1, 2, Sq, Dh)
    assert plan(torch.bfloat16, Sq, Sq, Dh, 2)[0] == "tc_prefill"
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), attention_ref(q, k, v,
                                                          causal=causal),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("Dh", [64, 128])
def test_tc_prefill_on_views_with_unseeing_rows(cuda, Dh):
    """q, k and v as [B, S, H, Dh] slices of one fused projection (GQA,
    3 query heads per KV head), Sq > Skv: the first rows see no key and
    must be exactly 0."""
    rng = np.random.default_rng(Dh)
    B, S, Hq, Hkv, skv = 2, 150, 6, 2, 100
    qkv = _bf16(rng, B, S, (Hq + 2 * Hkv) * Dh, scale=0.3)
    q = qkv[..., :Hq * Dh].view(B, S, Hq, Dh)
    k = qkv[:, :skv, Hq * Dh:(Hq + Hkv) * Dh].view(B, skv, Hkv, Dh)
    v = qkv[:, :skv, (Hq + Hkv) * Dh:].view(B, skv, Hkv, Dh) * 3
    assert not q.is_contiguous() and not k.is_contiguous()
    out = attention_bshd(q, k, v)
    torch.cuda.synchronize()
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(out.float(), want, rtol=2e-2, atol=2e-2)
    assert not out[:, :S - skv].any()


@pytest.mark.parametrize("kv_len", [1, 5, 64, 65, 1087, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_on_a_strided_cache_view(cuda, kv_len, dtype):
    rng = np.random.default_rng(kv_len)
    cache = torch.from_numpy(rng.standard_normal(
        (2, 2, kv_len + 9, 2, 64)).astype(np.float32)).to(cuda, dtype)
    k, v = cache[0, :, :kv_len], cache[1, :, :kv_len]
    q = torch.from_numpy(rng.standard_normal((2, 1, 6, 64)).astype(
        np.float32) * 0.3).to(cuda, dtype)
    assert not k.is_contiguous()
    design, nsplit = plan(dtype, 3, kv_len, 64, 4)
    assert design == "split_decode" and (nsplit > 1) == (kv_len >= 128)
    before = flash_attention.launches
    out = attention_bshd(q, k, v, offset=kv_len - 1, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), offset=kv_len - 1,
                         kv_len=kv_len).transpose(1, 2)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_ranges_that_see_no_key(cuda, dtype):
    """A 5-token chunk at offset 40 of a 1000-key cache: the keys are
    split by kv_len, so every range past key 44 sees nothing; with
    offset -10 no row sees anything and the output is 0."""
    rng = np.random.default_rng(7)

    def t(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(cuda, dtype)
    q, k, v = t(1, 5, 6, 64, scale=0.3), t(1, 1000, 2, 64, scale=0.3), \
        t(1, 1000, 2, 64)
    assert plan(dtype, 15, 1000, 64, 2)[1] > 1
    out = attention_bshd(q, k, v, offset=40, kv_len=1000)
    torch.cuda.synchronize()
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), offset=40,
                         kv_len=1000).transpose(1, 2)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)
    none = attention_bshd(q, k, v, offset=-10, kv_len=1000)
    torch.cuda.synchronize()
    assert torch.isfinite(none).all() and not none.any()


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
