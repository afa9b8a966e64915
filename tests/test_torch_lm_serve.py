"""LM serving through the port: ``serve_lm(..., device="cpu")`` at the
reduced smollm-360m config gives the same greedy tokens as a JAX
prefill/decode loop (the JAX package's ``serve_lm`` body) on the same
weights and prompts, and the CLI serves the LM family.  Tokens: tolerance
ZERO; last-position logits within 3e-4 (the JAX package's bound between
its attention backends)."""

import _torch_env  # noqa: F401  (first: one torch thread)
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import transformer as ref_tf
from repro_torch.configs import get_arch
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve as port_serve

BATCH, PROMPT, TOKENS = 3, 24, 6


@pytest.fixture(scope="module")
def reference():
    """The JAX package's greedy loop on its own weights, as its
    ``serve_lm`` runs it (prompts from ``default_rng(0)``)."""
    cfg = ref_get_arch("smollm-360m").make_reduced()
    params = ref_tf.init_params(cfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    prompts = jnp.asarray(rng.integers(0, cfg.vocab, (BATCH, PROMPT)))
    prefill = jax.jit(lambda p, t: ref_tf.prefill(p, t, cfg,
                                                  max_len=PROMPT + TOKENS))
    decode = jax.jit(lambda p, t, c: ref_tf.decode_step(p, t, c, cfg))
    logits, cache = prefill(params, prompts)
    toks = jnp.argmax(logits, -1)[:, None]
    outs, steps = [toks], [logits]
    for _ in range(TOKENS - 1):
        logits, cache = decode(params, toks, cache)
        toks = jnp.argmax(logits, -1)[:, None]
        outs.append(toks)
        steps.append(logits)
    return (jax.tree_util.tree_map(np.asarray, params),
            np.asarray(jnp.concatenate(outs, axis=1)),
            np.stack([np.asarray(s) for s in steps]))


def test_serve_lm_matches_the_jax_greedy_loop(reference):
    params_np, want_tokens, want_logits = reference
    cfg = get_arch("smollm-360m").make_reduced()
    params = transformer_params_from_numpy(params_np, cfg, device="cpu")
    before = flash_attention.launches
    tokens, timings = port_serve.serve_lm(
        cfg, batch=BATCH, prompt_len=PROMPT, n_tokens=TOKENS, device="cpu",
        params=params, keep_logits=True)
    assert flash_attention.launches == before    # CPU: the plain paths
    assert tokens.dtype == np.int64 and tokens.shape == (BATCH, TOKENS)
    np.testing.assert_array_equal(tokens, want_tokens)
    assert timings["logits"].shape == (TOKENS, BATCH, cfg.vocab)
    np.testing.assert_allclose(timings["logits"], want_logits,
                               rtol=3e-4, atol=3e-4)
    assert timings["decode_steps"] == TOKENS - 1
    assert timings["prefill_s"] > 0 and timings["tokens_per_s"] > 0


def test_serve_lm_prompts_and_device(reference):
    cfg = get_arch("smollm-360m").make_reduced()
    # the default prompts are the JAX package's draw: passing them is a no-op
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8))
    a, _ = port_serve.serve_lm(cfg, batch=2, prompt_len=8, n_tokens=3,
                               device="cpu")
    b, t = port_serve.serve_lm(cfg, batch=2, prompt_len=8, n_tokens=3,
                               device="cpu", prompts=prompts)
    np.testing.assert_array_equal(a, b)
    assert "logits" not in t
    with pytest.raises(ValueError, match="prompts"):
        port_serve.serve_lm(cfg, batch=3, prompt_len=8, n_tokens=3,
                            device="cpu", prompts=prompts)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_serve.serve_lm(cfg, batch=2, prompt_len=8, n_tokens=3)


def test_cli_serves_the_lm_family(tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="repro_torch.serve"):
        port_serve.main(["--arch", "smollm-360m", "--reduced", "--device",
                         "cpu", "--batch", "2", "--prompt-len", "8",
                         "--tokens", "4"])
    assert any("prefill" in r.message and "tok/s" in r.message
               for r in caplog.records)
    for arch in ("qwen2-moe-a2.7b", "dbrx-132b"):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="repro_torch.serve"):
            port_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "8",
                             "--tokens", "3"])
        assert any("prefill" in r.message and "tok/s" in r.message
                   for r in caplog.records), arch
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="repro_torch.serve"):
        port_serve.main(["--arch", "din", "--reduced", "--device", "cpu",
                         "--requests", "3", "--workdir", str(tmp_path)])
    assert any(r.message.startswith("DIN batch=4: p50")
               for r in caplog.records)
