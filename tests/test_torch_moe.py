"""The port's MoE transformer against the JAX package's, on the reduced
qwen2-moe-a2.7b and dbrx-132b configs in f32 with the JAX package's own
weights (carried over by ``convert.transformer_params_from_numpy``) and
the same numpy inputs.

``moe_ffn`` alone, both ``moe_dispatch`` arms, under ``no_drop``,
``eval_mode`` and a capacity that forces drops: output within 1e-5,
``lb_loss`` within 1e-6, and the routing, each assignment's place in its
expert and which assignments are kept or dropped equal as integers.  The
whole model: logits, caches, greedy tokens and ``lb_loss`` within 3e-4
(PR 13's dense parity; the JAX package's own bound between its attention
backends).

Routing is a top-k: where a token's K-th and (K+1)-th router
probabilities lie closer than f32 rounding (~1e-7) the two packages may
pick different experts and the token's output differs by O(1).  Every
test asserts that premise on its inputs (:func:`assert_margins`: each
routing call's smallest margin above ``MARGIN``) and fails loudly, naming
the margin, where it does not hold."""

import _torch_env  # noqa: F401  (first: one torch thread)
import contextlib
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

ARCHS = ["qwen2-moe-a2.7b", "dbrx-132b"]
TOL = 3e-4
#: smallest top-k margin (K-th minus (K+1)-th router probability) the
#: parity tests take: two orders above the packages' f32 differences
MARGIN = 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    ref_cfg = ref_get_arch(arch).make_reduced()
    cfg = get_arch(arch).make_reduced()
    ref_params = ref_tf.init_params(ref_cfg, jax.random.key(0))
    params = transformer_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, device="cpu")
    return arch, ref_cfg, cfg, ref_params, params


def margins(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Per token, the K-th largest router probability minus the
    (K+1)-th (inf where there are only K experts)."""
    top = torch.topk(probs, min(k + 1, probs.shape[-1]), dim=-1).values
    if top.shape[-1] == k:
        return torch.full(probs.shape[:-1], float("inf"))
    return top[..., k - 1] - top[..., k]


@contextlib.contextmanager
def recorded_routing(calls: list):
    """Every :func:`tf.route` call of the port appends its ``probs``."""
    real = tf.route

    def route(x, router, cfg):
        out = real(x, router, cfg)
        calls.append(out[0].detach())
        return out

    tf.route = route
    try:
        yield
    finally:
        tf.route = real


def assert_margins(calls: list, k: int) -> float:
    assert calls, "no routing call was recorded"
    low = min(float(margins(p, k).min()) for p in calls)
    assert low > MARGIN, (
        f"a token's top-{k} router margin is {low:.3g} <= {MARGIN}: the "
        f"two packages may route it differently, so these inputs cannot "
        f"hold the MoE to the reference")
    return low


def _layer0(ref_params, params):
    return (jax.tree_util.tree_map(lambda a: a[0], ref_params["layers"]),
            {k: v[0] for k, v in params["layers"].items()})


def ref_assignments(ref_idx: np.ndarray, n_slots: int, capacity: int):
    """The dispatch contract in plain numpy, from the JAX package's
    top-k: assignments ordered by expert, stably; each one's place in its
    expert; kept where that place is below the capacity."""
    flat = ref_idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    e_sorted = flat[order]
    t_sorted = np.repeat(np.arange(ref_idx.shape[0]), ref_idx.shape[1])[order]
    starts = np.concatenate([[0], np.cumsum(np.bincount(
        e_sorted, minlength=n_slots))[:-1]])
    pos = np.arange(flat.size) - starts[e_sorted]
    return order, e_sorted, t_sorted, pos, pos < capacity


MODES = {"no_drop": dict(no_drop=True), "eval_mode": dict(eval_mode=True),
         "drops": dict()}


@pytest.mark.parametrize("dispatch", ["scatter", "gather"])
@pytest.mark.parametrize("mode", list(MODES))
def test_moe_ffn_matches_the_reference(pair, dispatch, mode):
    _, ref_cfg, cfg, ref_params, params = pair
    # capacity factor 0.5 under "drops": a quarter to half of the
    # assignments overflow
    over = dict(moe_dispatch=dispatch,
                capacity_factor=0.5 if mode == "drops" else 2.0)
    ref_cfg = dataclasses.replace(ref_cfg, **over)
    cfg = dataclasses.replace(cfg, **over)
    rlp, lp = _layer0(ref_params, params)
    x = np.random.default_rng(2).standard_normal(
        (48, cfg.d_model)).astype(np.float32)
    kw = MODES[mode]
    want, want_lb = ref_tf.moe_ffn(jnp.asarray(x), rlp, ref_cfg, **kw)
    calls = []
    with recorded_routing(calls):
        got, lb = tf.moe_ffn(torch.from_numpy(x), lp, cfg, **kw)
    assert_margins(calls, cfg.top_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(lb), float(want_lb), rtol=1e-6,
                               atol=1e-6)

    # the integer contract: routing, places and drops
    C = tf.moe_capacity(cfg, x.shape[0], **kw)
    probs = jax.nn.softmax(jnp.asarray(x) @ rlp["router"], axis=-1)
    _, ref_idx = jax.lax.top_k(probs, cfg.top_k)
    _, _, idx = tf.route(torch.from_numpy(x), lp["router"], cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    want_ints = ref_assignments(np.asarray(ref_idx), cfg.e_pad, C)
    got_ints = tf.sort_assignments(idx, cfg.e_pad, C)
    for a, b in zip(got_ints, want_ints):
        np.testing.assert_array_equal(a.numpy(), b)
    kept = int(got_ints[4].sum())
    if mode == "drops":
        assert 0 < kept < idx.numel(), kept
    else:
        assert kept == idx.numel()


@pytest.mark.parametrize("mode", list(MODES))
def test_kept_assignments_fill_distinct_slots(pair, mode):
    """No two kept assignments share an (expert, place) slot, so the
    dispatch's ``index_put`` never sees a duplicate it would resolve in
    an arbitrary order; every dropped one lies past the capacity."""
    _, _, cfg, _, params = pair
    cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, cfg.d_model)).astype(np.float32))
    C = tf.moe_capacity(cfg, 64, **MODES[mode])
    _, _, idx = tf.route(x, lp["router"], cfg)
    _, e_sorted, _, pos, keep = tf.sort_assignments(idx, cfg.e_pad, C)
    slots = (e_sorted * C + pos)[keep]
    assert slots.unique().numel() == slots.numel()
    assert bool((pos[~keep] >= C).all()) and bool((pos >= 0).all())


def test_capacity_is_the_reference_arithmetic():
    cfg = get_arch("qwen2-moe-a2.7b").make_config()
    # the served shapes: prefill 8 x 1024 tokens, decode 8
    assert tf.moe_capacity(cfg, 8192, eval_mode=True) == 1024
    assert tf.moe_capacity(cfg, 8, no_drop=True, eval_mode=True) == 32
    assert tf.moe_capacity(cfg, 2048) == 160
    dbrx = get_arch("dbrx-132b").make_config()
    assert tf.moe_capacity(dbrx, 8192, eval_mode=True) == 4096
    assert tf.moe_capacity(dbrx, 3, eval_mode=True) == 1
    assert tf.moe_capacity(dbrx, 1, eval_mode=True) == 1


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dispatch", ["scatter", "gather"])
def test_forward_logits_and_lb_loss(pair, dispatch):
    _, ref_cfg, cfg, ref_params, params = pair
    ref_cfg = dataclasses.replace(ref_cfg, moe_dispatch=dispatch)
    cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 24))
    want, _, want_lb = ref_tf.forward(ref_params, jnp.asarray(toks), ref_cfg)
    calls = []
    with recorded_routing(calls), torch.inference_mode():
        got, cache, lb = tf.forward(params, torch.from_numpy(toks), cfg)
    assert len(calls) == cfg.n_layers
    assert_margins(calls, cfg.top_k)
    assert cache is None and lb.dtype == torch.float32
    _close(got, want)
    _close(lb, want_lb)


def test_prefill_cache_decode_and_greedy_tokens(pair):
    """A prefill of 16 tokens into a 24-slot cache, then 4 greedy decode
    steps (``no_drop`` and ``eval_mode``): last-position logits, the
    stacked caches and the greedy tokens against the JAX package's."""
    _, ref_cfg, cfg, ref_params, params = pair
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16))
    want, ref_cache = ref_tf.prefill(ref_params, jnp.asarray(prompts),
                                     ref_cfg, max_len=24)
    calls = []
    with recorded_routing(calls), torch.inference_mode():
        got, cache = tf.prefill(params, torch.from_numpy(prompts), cfg,
                                max_len=24)
        _close(got, want)
        want_tok = np.asarray(jnp.argmax(want, -1))[:, None]
        tok = got.argmax(-1)[:, None]
        np.testing.assert_array_equal(tok.numpy(), want_tok)
        for _ in range(4):
            want, ref_cache = ref_tf.decode_step(
                ref_params, jnp.asarray(want_tok), ref_cache, ref_cfg)
            got, cache = tf.decode_step(params, tok, cache, cfg)
            _close(got, want)
            want_tok = np.asarray(jnp.argmax(want, -1))[:, None]
            tok = got.argmax(-1)[:, None]
            np.testing.assert_array_equal(tok.numpy(), want_tok)
    assert_margins(calls, cfg.top_k)
    assert cache["len"] == int(ref_cache["len"]) == 20
    for key in ("k", "v"):
        _close(torch.stack(cache[key]), ref_cache[key])


def test_configs_params_and_counts_mirror_the_reference(pair):
    arch, ref_cfg, cfg, ref_params, params = pair
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
    mine = tf.init_params(cfg, torch.Generator().manual_seed(0))
    assert sorted(mine["layers"]) == sorted(ref_params["layers"])
    for k, v in ref_params["layers"].items():
        assert tuple(mine["layers"][k].shape) == v.shape, k
        assert mine["layers"][k].dtype == (
            torch.float32 if k == "router" else cfg.dtype), k
    # padded expert slots are drawn too; n_params() leaves them out
    n = sum(t.numel() for t in mine["layers"].values()) + sum(
        t.numel() for k, t in mine.items() if k != "layers")
    pad = cfg.n_layers * (cfg.e_pad - cfg.n_experts) * 3 * cfg.d_model \
        * cfg.moe_d_ff
    final_bias = cfg.d_model if cfg.norm == "layernorm" else 0
    assert n - pad - final_bias == cfg.n_params()


def test_bf16_config_keeps_the_router_in_f32(pair):
    """``cfg.dtype`` bf16 (the full configs' dtype): every weight bf16
    but the router, float32 in both packages; the shared gate is
    promoted to f32 as JAX promotes it, and the call runs."""
    arch, ref_cfg, cfg, ref_params, _ = pair
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params = transformer_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg16, device="cpu")
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["we_up"].dtype == torch.bfloat16
    mine = tf.init_params(cfg16, torch.Generator().manual_seed(0))
    assert mine["layers"]["router"].dtype == torch.float32
    with torch.inference_mode():
        logits, _, lb = tf.forward(params, torch.zeros(2, 6,
                                                       dtype=torch.long),
                                   cfg16)
    assert logits.dtype == torch.bfloat16 and lb.dtype == torch.float32
    assert torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_counts_equal_the_reference(arch):
    a, b = get_arch(arch).make_config(), ref_get_arch(arch).make_config()
    assert a.n_params() == b.n_params()
    assert a.n_active_params() == b.n_active_params()
    assert a.e_pad == b.e_pad
