"""K3, flash attention: the port's ``flash_attention`` on CPU tensors (its
plain version) against the JAX package's op with the Pallas kernel in
interpret mode and against its oracle ``attention_ref``, on the same
numpy inputs.  Tolerance as the JAX package holds its own kernel
(``tests/test_kernels.py``): f32 rtol/atol 2e-4, bf16 2e-2."""

import _torch_env  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as ref_oracle
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models import transformer as ref_tf
from repro_torch.kernels.flash_attention import (attention_bshd,
                                                 attention_ref,
                                                 flash_attention)

SWEEP = [
    (2, 4, 2, 256, 256, 64, True),
    (1, 8, 8, 128, 128, 128, True),
    (1, 4, 1, 1, 384, 64, True),      # decode
    (2, 6, 3, 100, 100, 64, True),    # unaligned -> padding
    (1, 2, 2, 64, 256, 64, True),     # chunked prefill
    (1, 2, 2, 128, 128, 64, False),
    (1, 15, 5, 64, 64, 64, True),     # smollm-style heads
]


def _qkv(B, Hq, Hkv, Sq, Skv, Dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, Dh)).astype(np.float32) * 0.3
    k = rng.standard_normal((B, Hkv, Skv, Dh)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, Hkv, Skv, Dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,Dh,causal", SWEEP)
def test_sweep_matches_the_jax_op_and_oracle(B, Hq, Hkv, Sq, Skv, Dh, causal):
    q, k, v = _qkv(B, Hq, Hkv, Sq, Skv, Dh, Sq + Skv)
    before = flash_attention.launches
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal)
    assert flash_attention.launches == before   # a CPU tensor never launches
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    op = np.asarray(ref_flash(jq, jk, jv, causal=causal, interpret=True))
    oracle = np.asarray(ref_oracle(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(got.numpy(), op, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-4, atol=2e-4)


def test_bf16_matches_the_jax_op():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 4, 128, 64)).astype(np.float32)
    k = rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
    v = rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    op = ref_flash(jq, jk, jv, causal=True, interpret=True)
    assert op.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(op, dtype=np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref_oracle(jq, jk, jv)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("S", [1, 5])
def test_strided_cache_entry_matches_the_jax_transformer(S):
    """A [B, Smax, Hk, dh] cache holding ``live`` positions, its new
    S-token chunk at ``live - S``: the port's entry on the cache's strided
    view with offset/kv_len equals the JAX transformer's dense attention
    over the whole cache with q_offset, and the JAX op on the live part."""
    B, Smax, H, Hk, dh, live = 2, 48, 6, 2, 64, 37
    rng = np.random.default_rng(S)
    cache_k = rng.standard_normal((B, Smax, Hk, dh)).astype(np.float32) * 0.3
    cache_v = rng.standard_normal((B, Smax, Hk, dh)).astype(np.float32)
    cache_k[:, live:] = cache_v[:, live:] = 0.0       # the zero tail
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32) * 0.3
    tk, tv = torch.from_numpy(cache_k), torch.from_numpy(cache_v)
    view_k, view_v = tk[:, :live], tv[:, :live]
    assert not view_k.is_contiguous()
    got = attention_bshd(torch.from_numpy(q), view_k, view_v,
                         offset=live - S, kv_len=live)
    # the same through the full cache: kv_len masks the zero tail
    full = attention_bshd(torch.from_numpy(q), tk, tv, offset=live - S,
                          kv_len=live)
    want = np.asarray(ref_tf._dense_attention(
        jnp.asarray(q), jnp.asarray(cache_k), jnp.asarray(cache_v),
        causal=True, q_offset=live - S))
    op = np.asarray(ref_flash(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jnp.asarray(cache_k[:, :live].transpose(0, 2, 1, 3)),
        jnp.asarray(cache_v[:, :live].transpose(0, 2, 1, 3)),
        causal=True, interpret=True)).transpose(0, 2, 1, 3)
    assert got.is_contiguous() and tuple(got.shape) == (B, S, H, dh)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), op, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(full.numpy(), want, rtol=2e-4, atol=2e-4)
    # without kv_len the decode convention would align the last query row
    # with the cache's last (zero) slot: a different answer
    wrong = attention_bshd(torch.from_numpy(q), tk, tv)
    assert not np.allclose(wrong.numpy(), want, rtol=2e-4, atol=2e-4)


def test_fully_masked_rows_are_zero():
    # Sq > Skv: query rows i < Sq - Skv see no key
    q, k, v = _qkv(1, 4, 2, 40, 16, 64, 7)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v)).numpy()
    assert np.isfinite(got).all()
    assert not got[:, :, :24].any()
    oracle = np.asarray(ref_oracle(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v)))
    assert np.isnan(oracle[:, :, :24]).all()      # the oracle's -inf
    np.testing.assert_allclose(got[:, :, 24:], oracle[:, :, 24:],
                               rtol=2e-4, atol=2e-4)
    # kv_len = 0: every row sees nothing
    z = attention_bshd(torch.ones(1, 3, 2, 64), torch.ones(1, 5, 1, 64),
                       torch.ones(1, 5, 1, 64), kv_len=0)
    assert not z.any()


def test_plain_version_equals_a_loop_over_rows():
    q, k, v = _qkv(1, 6, 2, 7, 11, 64, 3)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), offset=2, kv_len=9).numpy()
    want = np.zeros_like(q)
    for h in range(6):
        for i in range(7):
            keys = [j for j in range(9) if j <= i + 2]
            s = q[0, h, i] @ k[0, h // 3, keys].T / 8.0
            p = np.exp(s - s.max())
            want[0, h, i] = p @ v[0, h // 3, keys] / p.sum()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_requires_grad_and_bad_arguments_raise():
    q = torch.zeros(1, 4, 8, 64)
    kv = torch.zeros(1, 2, 8, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q.clone().requires_grad_(), kv, kv)
    with torch.no_grad():
        flash_attention(q.clone().requires_grad_(), kv, kv)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(torch.zeros(1, 3, 8, 64), kv, kv)
    with pytest.raises(ValueError, match="differ"):
        flash_attention(q, kv, kv[:, :, :4])
    with pytest.raises(ValueError, match="kv_len"):
        attention_bshd(q.transpose(1, 2), kv.transpose(1, 2),
                       kv.transpose(1, 2), kv_len=9)
    with pytest.raises(TypeError, match="floating"):
        flash_attention(q.int(), kv, kv)
    with pytest.raises(ValueError, match="4-D"):
        flash_attention(q[0], kv, kv)
