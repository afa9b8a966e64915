"""K3's split-decode design and the choice of design, on the CPU.

The split design cuts the keys of a call into ranges, computes each
range's partial (m, l, acc) in a block of its own and merges them in a
second kernel.  ``attention_split_ref`` is that arithmetic in plain
PyTorch; here it is held against the JAX package's op (its Pallas kernel
in interpret mode) and against ``attention_ref`` on the same numpy
inputs, at the JAX package's f32 kernel tolerance (rtol/atol 2e-4).
``plan`` is the pure function that picks a design and a split count for
the CUDA launcher; its choices are checked at smollm-360m's served
shapes and at each boundary."""

import _torch_env  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 attention_split_ref, plan)
from repro_torch.kernels.flash_attention.ref import (merge_splits,
                                                     split_partials)

# decode-shaped cases: (B, Hq, Hkv, Sq, kv_len)
DECODE = [
    (1, 4, 1, 1, 384),       # the JAX sweep's decode case
    (2, 15, 5, 1, 137),      # smollm-style heads, kv_len off every grid
    (1, 6, 2, 5, 70),        # a 5-token chunk
]


def _qkv(B, Hq, Hkv, Sq, Skv, Dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, Dh)).astype(np.float32) * 0.3
    k = rng.standard_normal((B, Hkv, Skv, Dh)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, Hkv, Skv, Dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("nsplit", [1, 3, 7, 500])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,kv_len", DECODE)
def test_split_and_merge_match_the_jax_op(B, Hq, Hkv, Sq, kv_len, nsplit):
    """kv_len rarely a multiple of the split; nsplit = 500 leaves most
    ranges without a key."""
    q, k, v = _qkv(B, Hq, Hkv, Sq, kv_len, 64, kv_len + nsplit)
    got = attention_split_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), nsplit=nsplit).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    op = np.asarray(ref_flash(jq, jk, jv, causal=True, interpret=True))
    np.testing.assert_allclose(got, op, rtol=2e-4, atol=2e-4)
    want = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_ranges_past_the_visible_keys_are_empty():
    """A 2-token chunk at offset 40 of a cache whose kv_len (300) sets
    the split: ranges past key 41 see nothing (m = -inf, l = 0,
    acc = 0), and the merge still equals the JAX op over the live keys."""
    B, Hq, Hkv, Sq, Skv, live, offset = 1, 6, 2, 2, 320, 300, 40
    q, k, v = _qkv(B, Hq, Hkv, Sq, Skv, 64, 11)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    m, l, acc = split_partials(tq, tk, tv, nsplit=6, offset=offset,
                               kv_len=live)
    assert torch.isfinite(m[0]).all()          # keys 0..49
    assert torch.isneginf(m[1:]).all()
    assert not l[1:].any() and not acc[1:].any()
    got = merge_splits(m, l, acc).numpy()
    # the JAX op's decode convention puts the visible keys at 0..41
    op = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k[:, :, :42]),
                              jnp.asarray(v[:, :, :42]), causal=True,
                              interpret=True))
    np.testing.assert_allclose(got, op, rtol=2e-4, atol=2e-4)
    want = attention_ref(tq, tk, tv, offset=offset, kv_len=live).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_rows_that_see_no_key_merge_to_zero():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, 3, 50, 64, 5))
    # offset -3: the first three positions see nothing at all
    got = attention_split_ref(q, k, v, nsplit=4, offset=-3)
    assert torch.isfinite(got).all() and not got.any()
    assert not attention_split_ref(q, k, v, nsplit=4, kv_len=0).any()


def test_split_matches_the_reference_without_the_causal_mask():
    q, k, v = map(torch.from_numpy, _qkv(2, 4, 2, 3, 200, 128, 9))
    got = attention_split_ref(q, k, v, nsplit=5, causal=False, kv_len=187)
    want = attention_ref(q, k, v, causal=False, kv_len=187)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype,rows,kv_len,dh,pairs,want", [
    # smollm-360m served: decode step over 1087 keys, 8 x 5 KV heads
    (torch.bfloat16, 3, 1087, 64, 40, ("split_decode", 9)),
    # served prefill, 8 x 1024 tokens, 3 query heads per KV head
    (torch.bfloat16, 3072, 1024, 64, 40, ("tc_prefill", 1)),
    # the f32 correctness run's prefill (2 x 512)
    (torch.float32, 1536, 512, 64, 10, ("fma", 1)),
    # the row boundary between the split and the tile designs
    (torch.bfloat16, 32, 1087, 64, 40, ("split_decode", 9)),
    (torch.bfloat16, 33, 1087, 64, 40, ("tc_prefill", 1)),
    (torch.float32, 32, 1087, 128, 40, ("split_decode", 9)),
    (torch.float32, 33, 1087, 128, 40, ("fma", 1)),
    # fewer than 2 x 64 keys: one range, no combine
    (torch.float32, 1, 127, 64, 1, ("split_decode", 1)),
    (torch.bfloat16, 1, 1, 64, 1, ("split_decode", 1)),
    (torch.bfloat16, 1, 0, 64, 1, ("split_decode", 1)),
    # a long cache on one head: capped at kv_len / 64 and at 64 ranges
    (torch.bfloat16, 6, 4096, 128, 1, ("split_decode", 64)),
    (torch.bfloat16, 6, 1000, 128, 1, ("split_decode", 15)),
    # many heads: the SM cover is met, ~128 keys a range
    (torch.float32, 1, 4096, 64, 512, ("split_decode", 32)),
])
def test_plan_at_the_served_shapes_and_boundaries(dtype, rows, kv_len, dh,
                                                  pairs, want):
    got = plan(dtype, rows, kv_len, dh, pairs)
    assert got == want
    design, nsplit = got
    if design == "split_decode" and rows <= 3 and kv_len >= 1024:
        assert pairs * nsplit >= 2 * 132      # the SMs covered twice
        assert -(-kv_len // nsplit) >= 64


def test_plan_refuses_what_no_design_takes():
    with pytest.raises(ValueError, match="Dh"):
        plan(torch.bfloat16, 3, 100, 96, 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        plan(torch.float16, 3, 100, 64, 1)


def test_plan_split_counts_keep_their_limits():
    """Over a grid of few-row calls: 1 <= nsplit <= SPLIT_MAX, every range
    of a split call keeps >= SPLIT_MIN_KEYS keys, and the grid covers the
    SMs twice wherever the keys allow it."""
    from repro_torch.kernels.flash_attention import ops

    for kv_len in (0, 1, 63, 64, 127, 128, 129, 1087, 4096, 10 ** 5):
        for pairs in (1, 5, 40, 264, 1000):
            for rows in (1, 3, ops.SPLIT_MAX_ROWS):
                design, nsplit = plan(torch.bfloat16, rows, kv_len, 64, pairs)
                assert design == "split_decode"
                assert 1 <= nsplit <= ops.SPLIT_MAX
                if nsplit > 1:
                    assert kv_len // nsplit >= ops.SPLIT_MIN_KEYS
                cap = min(kv_len // ops.SPLIT_MIN_KEYS, ops.SPLIT_MAX)
                if cap >= 2 * ops.H100_SMS / pairs:
                    assert pairs * nsplit >= 2 * ops.H100_SMS
