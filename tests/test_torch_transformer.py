"""The port's transformer against the JAX package's, on the reduced
smollm-360m, qwen2-1.5b and stablelm-1.6b configs in f32 with the JAX
package's own weights (carried over by
``convert.transformer_params_from_numpy``) and the same numpy tokens.
Tolerance 3e-4 (rtol and atol): the JAX package's own bound between its
attention backends (``tests/test_models_lm.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import transformer as ref_tf
from repro_torch.configs import get_arch
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.models import transformer as tf

ARCHS = ["smollm-360m", "qwen2-1.5b", "stablelm-1.6b"]
TOL = 3e-4
CHUNK = 16          # several KV chunks per sequence on the chunked path


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    ref_cfg = ref_get_arch(arch).make_reduced()
    cfg = get_arch(arch).make_reduced()
    ref_params = ref_tf.init_params(ref_cfg, jax.random.key(0))
    params = transformer_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40))
    return arch, ref_cfg, cfg, ref_params, params, toks


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_forward_logits(pair, impl):
    _, ref_cfg, cfg, ref_params, params, toks = pair
    ref_cfg = dataclasses.replace(ref_cfg, attn_impl=impl, attn_chunk=CHUNK)
    cfg = dataclasses.replace(cfg, attn_impl=impl, attn_chunk=CHUNK)
    want, _, _ = ref_tf.forward(ref_params, jnp.asarray(toks), ref_cfg)
    with torch.inference_mode():
        got, cache, lb = tf.forward(params, torch.from_numpy(toks), cfg)
    assert cache is None and float(lb) == 0.0
    assert tuple(got.shape) == (2, 40, cfg.vocab)
    _close(got, want)


def test_prefill_cache_and_three_decode_steps(pair):
    _, ref_cfg, cfg, ref_params, params, toks = pair
    ref_cfg = dataclasses.replace(ref_cfg, attn_chunk=CHUNK)
    cfg = dataclasses.replace(cfg, attn_chunk=CHUNK)
    want, ref_cache = ref_tf.prefill(ref_params, jnp.asarray(toks[:, :30]),
                                     ref_cfg, max_len=40)
    with torch.inference_mode():
        got, cache = tf.prefill(params, torch.from_numpy(toks[:, :30]), cfg,
                                max_len=40)
    _close(got, want)
    assert cache["len"] == int(ref_cache["len"]) == 30
    # the port's per-layer list, stacked, is the JAX package's [L, ...]
    for key in ("k", "v"):
        assert len(cache[key]) == cfg.n_layers
        assert tuple(cache[key][0].shape) == (2, 40, cfg.n_kv_heads,
                                              cfg.d_head)
        _close(torch.stack(cache[key]), ref_cache[key])
    for s in range(3):
        t = toks[:, 30 + s:31 + s]
        want, ref_cache = ref_tf.decode_step(ref_params, jnp.asarray(t),
                                             ref_cache, ref_cfg)
        with torch.inference_mode():
            got, cache = tf.decode_step(params, torch.from_numpy(t), cache,
                                        cfg)
        assert tuple(got.shape) == (2, cfg.vocab)
        _close(got, want)
        assert cache["len"] == int(ref_cache["len"]) == 31 + s
    for key in ("k", "v"):
        _close(torch.stack(cache[key]), ref_cache[key])


def test_configs_and_param_counts_mirror_the_reference(pair):
    arch, ref_cfg, cfg, ref_params, params, _ = pair
    spec, ref_spec = get_arch(arch), ref_get_arch(arch)
    assert (spec.family, spec.citation) == (ref_spec.family,
                                            ref_spec.citation)
    for make in ("make_config", "make_reduced"):
        a, b = getattr(spec, make)(), getattr(ref_spec, make)()
        for f in dataclasses.fields(b):
            if f.name != "dtype":
                assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert str(a.dtype).split(".")[-1] == jnp.dtype(b.dtype).name
        assert a.n_params() == b.n_params()
        assert a.n_active_params() == b.n_active_params()
    # init_params: the reference's keys and shapes, cfg.dtype
    mine = tf.init_params(cfg, torch.Generator().manual_seed(0))
    assert sorted(mine) == sorted(ref_params)
    assert sorted(mine["layers"]) == sorted(ref_params["layers"])
    for k, v in ref_params["layers"].items():
        assert tuple(mine["layers"][k].shape) == v.shape, k
        assert mine["layers"][k].dtype == cfg.dtype
    n = sum(t.numel() for t in mine["layers"].values()) + sum(
        t.numel() for k, t in mine.items() if k != "layers")
    # n_params() (as the reference has it) leaves out LayerNorm's final
    # bias: d parameters
    assert n - (cfg.d_model if cfg.norm == "layernorm" else 0) == \
        cfg.n_params()


def test_moe_and_mesh_options_raise():
    """The MoE configs build and count as the reference's (the MoE FFN
    is ported); the mesh fields, which raised while the port had no mesh
    layer, now build a config whose logits equal those without them (a
    sharding constraint is the identity on one process's tensors), and
    ``attn_kv_expand`` repeats the KV heads to the same logits."""
    moe = ref_get_arch("qwen2-moe-a2.7b").make_reduced()
    fields = {f.name: getattr(moe, f.name) for f in dataclasses.fields(moe)}
    fields["dtype"] = torch.float32
    cfg = tf.TransformerConfig(**fields)
    assert cfg.n_params() == moe.n_params()
    assert cfg.n_active_params() == moe.n_active_params()
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    assert params["layers"]["router"].dtype == torch.float32
    assert tuple(params["layers"]["we_gate"].shape) == (
        cfg.n_layers, cfg.e_pad, cfg.d_model, cfg.moe_d_ff)
    tokens = torch.randint(0, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        logits, _, lb = tf.forward(params, tokens, cfg)
        meshed = dataclasses.replace(cfg, moe_ep_axis="model",
                                     attn_head_axis="model",
                                     batch_axes=("data",))
        assert torch.equal(tf.forward(params, tokens, meshed)[0], logits)
    assert tuple(logits.shape) == (2, 6, cfg.vocab) and float(lb) > 0
    dense = dataclasses.replace(get_arch("smollm-360m").make_reduced(),
                                dtype=torch.float32)
    dparams = tf.init_params(dense, torch.Generator().manual_seed(2))
    want = tf.loss_fn(dparams, tokens % dense.vocab, tokens % dense.vocab,
                      dense)
    for name, value in (("attn_head_axis", "model"), ("batch_axes", ("data",)),
                        ("attn_batch_shard_axes", ("data",)),
                        ("moe_ep_axis", "model"), ("attn_kv_expand", True)):
        got = tf.loss_fn(dparams, tokens % dense.vocab, tokens % dense.vocab,
                         dataclasses.replace(dense, **{name: value}))
        assert torch.allclose(got, want, rtol=1e-6, atol=0), name


def test_rope_and_norms_match_the_reference():
    from repro.models.common import layer_norm as ref_ln
    from repro.models.common import rms_norm as ref_rms
    from repro_torch.models.common import layer_norm, rms_norm

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7)[None, :] + 5
    for pct in (1.0, 0.25):
        ref_cfg = ref_tf.TransformerConfig(d_head=16, rope_pct=pct)
        cfg = tf.TransformerConfig(d_head=16, rope_pct=pct)
        want = ref_tf.apply_rope(jnp.asarray(x), jnp.asarray(pos), ref_cfg)
        got = tf.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    s = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(ref_rms(jnp.asarray(x), jnp.asarray(s))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                   torch.from_numpy(b)).numpy(),
        np.asarray(ref_ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert rms_norm(xb, torch.from_numpy(s)).dtype == torch.bfloat16


def test_attn_p_bf16_and_kv_expand_stay_within_the_reference_bounds(pair):
    _, ref_cfg, cfg, ref_params, params, toks = pair
    opts = dict(attn_chunk=CHUNK, attn_p_bf16=True, attn_kv_expand=True)
    want, _, _ = ref_tf.forward(ref_params, jnp.asarray(toks),
                                dataclasses.replace(ref_cfg, **opts))
    with torch.inference_mode():
        got, _, _ = tf.forward(params, torch.from_numpy(toks),
                               dataclasses.replace(cfg, **opts))
    # p in bf16: the reference's own <= 1e-2 compromise
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("rope_pct", [1.0, 0.25])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_place_serving_ops_equal_the_training_ones(rope_pct, dtype):
    """Without grad, RoPE and SwiGLU run in place: the same bits as the
    out-of-place ops the training route takes."""
    cfg = dataclasses.replace(get_arch("smollm-360m").make_reduced(),
                              rope_pct=rope_pct)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 3, cfg.d_head, generator=g).to(dtype)
    pos = torch.arange(5)[None].expand(2, 5) + 7
    w = [torch.randn(cfg.d_head, 16, generator=g).to(dtype),
         torch.randn(cfg.d_head, 16, generator=g).to(dtype),
         torch.randn(16, cfg.d_head, generator=g).to(dtype)]
    with torch.enable_grad():
        want_r, want_s = tf.apply_rope(x, pos, cfg), tf.swiglu(x, *w)
    with torch.no_grad():
        got_r, got_s = tf.apply_rope(x, pos, cfg), tf.swiglu(x, *w)
    assert torch.equal(got_r, want_r) and torch.equal(got_s, want_s)
