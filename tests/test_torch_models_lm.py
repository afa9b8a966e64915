"""The JAX package's transformer-family tests (``tests/test_models_lm.py``)
on the port: a training step's loss and gradients finite, prefill plus a
decode step equal to the full forward, the attention backends agreeing,
MoE routing under ``no_drop`` equal to a dense loop over the experts,
the load-balance loss positive, the published parameter counts.  Marked
``slow`` as the JAX package marks its own; the tier-1 parity against the
JAX package is ``tests/test_torch_{transformer,moe,lm_train}.py``."""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models.transformer import (TransformerConfig, decode_step,
                                            forward, init_params, loss_fn,
                                            moe_ffn, prefill)
from repro_torch.optim.adamw import tree_leaves, tree_map

pytestmark = pytest.mark.slow

CFG = TransformerConfig(n_layers=2, d_model=64, n_heads=6, n_kv_heads=2,
                        d_head=16, d_ff=128, vocab=256, dtype=torch.float32,
                        attn_impl="chunked", attn_chunk=32, qkv_bias=True,
                        rope_pct=0.5)

MOE_CFG = TransformerConfig(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=0,
    vocab=256, dtype=torch.float32, moe=True, n_experts=6,
    n_experts_padded=8, top_k=2, moe_d_ff=32, n_shared_experts=2,
    shared_d_ff=64, shared_expert_gate=True, capacity_factor=8.0)


@pytest.fixture(scope="module")
def toks():
    return torch.randint(0, 256, (2, 65),
                         generator=torch.Generator().manual_seed(1))


def _params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("cfg", [CFG, MOE_CFG], ids=["dense", "moe"])
def test_train_step_finite(cfg, toks):
    p = tree_map(lambda t: t.requires_grad_(), _params(cfg))
    loss = loss_fn(p, toks[:, :-1], toks[:, 1:], cfg)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("cfg", [CFG, MOE_CFG], ids=["dense", "moe"])
def test_prefill_decode_matches_forward(cfg, toks):
    p = _params(cfg)
    with torch.inference_mode():
        full, _, _ = forward(p, toks, cfg)
        last, cache = prefill(p, toks[:, :-1], cfg, max_len=80)
        torch.testing.assert_close(last, full[:, -2], rtol=2e-3, atol=2e-3)
        step, cache = decode_step(p, toks[:, -1:], cache, cfg)
        torch.testing.assert_close(step, full[:, -1], rtol=2e-3, atol=2e-3)
    assert cache["len"] == toks.shape[1]


def test_attention_backends_agree(toks):
    p = _params(CFG)
    with torch.inference_mode():
        outs = [forward(p, toks, dataclasses.replace(CFG, attn_impl=impl))[0]
                for impl in ("dense", "chunked")]
    torch.testing.assert_close(outs[0], outs[1], rtol=3e-4, atol=3e-4)


def test_kv_expand_equivalent(toks):
    p = _params(CFG)
    with torch.inference_mode():
        a, _, _ = forward(p, toks, CFG)
        b, _, _ = forward(p, toks, dataclasses.replace(CFG,
                                                       attn_kv_expand=True))
    torch.testing.assert_close(a, b, rtol=3e-4, atol=3e-4)


def test_moe_no_drop_exact_routing():
    """With no_drop, every token's top-k contribution must be present:
    compare against a dense loop over experts."""
    cfg = MOE_CFG
    lp = {k: v[0] for k, v in _params(cfg)["layers"].items()}
    x = torch.randn(10, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    out, _ = moe_ffn(x, lp, cfg, no_drop=True)
    probs = torch.softmax(x @ lp["router"], -1)
    gates, idx = torch.topk(probs, cfg.top_k)
    ref = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        h = torch.nn.functional.silu(x @ lp["we_gate"][e]) * \
            (x @ lp["we_up"][e])
        w = torch.where(idx == e, gates, 0).sum(-1)
        ref = ref + w[:, None] * (h @ lp["we_down"][e])
    shared = (torch.nn.functional.silu(x @ lp["ws_gate"]) * (x @ lp["ws_up"])
              ) @ lp["ws_down"]
    ref = ref + shared * torch.sigmoid(x @ lp["shared_gate"])
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-4)


def test_moe_load_balance_loss_positive():
    lp = {k: v[0] for k, v in _params(MOE_CFG)["layers"].items()}
    x = torch.randn(64, MOE_CFG.d_model,
                    generator=torch.Generator().manual_seed(3))
    _, lb = moe_ffn(x, lp, MOE_CFG)
    assert float(lb) > 0


@pytest.mark.parametrize("arch_id,expected_m", [
    ("smollm-360m", 360), ("qwen2-1.5b", 1540), ("stablelm-1.6b", 1640),
    ("qwen2-moe-a2.7b", 14300), ("dbrx-132b", 132_000),
])
def test_param_counts_match_public_figures(arch_id, expected_m):
    n = get_arch(arch_id).make_config().n_params() / 1e6
    assert abs(n - expected_m) / expected_m < 0.12, f"{arch_id}: {n:.0f}M"


def test_active_params_moe():
    active = get_arch("qwen2-moe-a2.7b").make_config().n_active_params() / 1e9
    assert 2.0 < active < 3.5  # "A2.7B"
