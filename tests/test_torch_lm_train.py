"""LM training through the port against the JAX package, on the CPU: the
loss and its gradients (``loss_fn``, dense and MoE, on the reduced
configs in f32 with the JAX package's own weights), the token shards
(``data/tokens.py``: the same bytes on disk, the same windows read
back), the training driver's LM batches and steps, and an LM training
state's checkpoints cross-restored.

Tolerances: the loss within 1e-5; every gradient of both packages within
1e-4 x max|g| of a float64 run of the same function (either package's
f32 gradients lie up to 4e-5 x max|g| from it, so the two f32 runs
cannot meet rtol 1e-4 / atol 1e-6 x max|g| of each other); shard bytes,
token windows and checkpoint leaves equal bit for bit.  The MoE cases
assert their routing margin premise (``test_torch_moe.assert_margins``)
on every layer's router before holding the grads."""

import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.launch.train as ref_train
from repro import checkpoint as ref_ck
from repro.configs import get_arch as ref_get_arch
from repro.data import tokens as ref_tokens
from repro.models import transformer as ref_tf
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro_torch import checkpoint as ck
from repro_torch.configs import get_arch
from repro_torch.convert import (adamw_state_from_numpy,
                                 transformer_params_from_numpy)
from repro_torch.data import tokens
from repro_torch.kernels.compbin_decode import compbin_decode
from repro_torch.launch import train
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import tree_leaves, tree_map

from test_torch_moe import assert_margins, recorded_routing

ARCHS = ["smollm-360m", "qwen2-moe-a2.7b", "dbrx-132b"]
CPU = "cpu"


def _ref_and_port(arch, dtype=None):
    rcfg = ref_get_arch(arch).make_reduced()
    cfg = get_arch(arch).make_reduced()
    if dtype is not None:
        rcfg = dataclasses.replace(rcfg, dtype=jnp.bfloat16)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    rparams = ref_tf.init_params(rcfg, jax.random.key(0))
    params = transformer_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), cfg, device=CPU)
    return rcfg, cfg, rparams, params


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {kk: v for k in sorted(tree)
                for kk, v in _flat(tree[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _segment_sum_f64(messages, segment_ids, num_segments):
    """The MoE combine's segment sum in float64 (ids outside [0, N)
    dropped)."""
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    out = torch.zeros(num_segments, messages.shape[1], dtype=torch.float64)
    return out.index_add_(0, torch.where(valid, segment_ids, 0).long(),
                          torch.where(valid[:, None], messages.double(), 0.0))


def _exact_grads(params, x, y, cfg, monkeypatch) -> dict:
    """The port's gradients in float64 throughout (params, norms,
    attention, router, combine and loss; ``models.common.wide`` keeps a
    float64 run float64), the arbiter both packages' f32 gradients are
    held to."""
    monkeypatch.setattr(tf, "segment_sum", _segment_sum_f64)
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    p = tree_map(lambda t: t.detach().double().requires_grad_(), params)
    loss = tf.loss_fn(p, torch.from_numpy(x), torch.from_numpy(y), cfg64)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    monkeypatch.undo()
    return {k: g.numpy() for k, g in zip(_flat(p), grads)}


def _share(a: dict, exact: dict) -> float:
    """The worst over parameters of ``a``'s max abs distance from
    ``exact`` as a share of that parameter's max|exact|."""
    return max(np.abs(np.asarray(a[k], np.float64) - v).max()
               / np.abs(v).max() for k, v in exact.items())


#: f32 gradients against the float64 run: the largest distance, as a
#: share of the parameter's max|g|, either package's may have
GRAD_SHARE = 1e-4


def _grads_close(got: dict, want: dict, exact: dict) -> float:
    """Each of the port's f32 gradients, and each of the JAX package's,
    within ``GRAD_SHARE`` x max|g| of the float64 run's; returns the
    port's worst share.  The float64 arbiter is the port's code, so the
    JAX package held to the same bound is what shows that the arbiter
    computes the reference's function."""
    got = {k: v.detach().numpy() for k, v in _flat(got).items()}
    want = {k: np.asarray(v) for k, v in _flat(want).items()}
    assert sorted(got) == sorted(want) == sorted(exact)
    for name, grads in (("port", got), ("JAX package", want)):
        for k, x in exact.items():
            err = np.abs(grads[k] - x).max()
            assert err <= GRAD_SHARE * np.abs(x).max(), \
                (f"{name}'s f32 gradient {k} lies {err} from the float64 "
                 f"run's, beyond {GRAD_SHARE} x max|g| "
                 f"{np.abs(x).max()}")
    return _share(got, exact)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch, monkeypatch):
    """The loss within 1e-5 of the JAX package's; the gradients held to
    a float64 run (:func:`_grads_close`).  Either package's f32
    gradients lie 1e-6 x max|g| or more from it -- on these inputs the
    JAX package's up to 2.0e-5, the port's up to 3.6e-5, and the JAX
    package's two attention backends alone 4e-6 apart -- so rtol 1e-4 /
    atol 1e-6 x max|g| between the two f32 runs cannot hold."""
    rcfg, cfg, rparams, params = _ref_and_port(arch)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 33))
    x, y = toks[:, :-1], toks[:, 1:]
    want, want_g = jax.value_and_grad(ref_tf.loss_fn)(
        rparams, jnp.asarray(x), jnp.asarray(y), rcfg)
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    calls = []
    with recorded_routing(calls):
        loss = tf.loss_fn(p, torch.from_numpy(x), torch.from_numpy(y), cfg)
        exact = _exact_grads(params, x, y, cfg, monkeypatch)
    if cfg.moe:
        assert len(calls) == 2 * cfg.n_layers
        assert_margins(calls, cfg.top_k)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    share = _grads_close(dict(zip(_flat(p), grads)), want_g, exact)
    # the measurement behind the arbiter: f32 rounding, not exactness
    assert share > 1e-6, share


def test_forward_hidden_and_ce_chunk_match_the_reference():
    """``forward_hidden`` is the training route's hidden states and
    load-balance loss; ``ce_chunk`` leaves the port's loss as it is and
    the JAX package's within f32 rounding."""
    rcfg, cfg, rparams, params = _ref_and_port("qwen2-moe-a2.7b")
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 20))
    want_x, want_lb = ref_tf.forward_hidden(rparams, jnp.asarray(toks), rcfg)
    x, lb = tf.forward_hidden(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(want_x),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(float(lb), float(want_lb), rtol=1e-6,
                               atol=1e-6)
    y = np.roll(toks, -1, axis=1)
    chunked = dataclasses.replace(rcfg, ce_chunk=8)
    want = ref_tf.loss_fn(rparams, jnp.asarray(toks), jnp.asarray(y),
                          chunked)
    got = tf.loss_fn(params, torch.from_numpy(toks), torch.from_numpy(y),
                     dataclasses.replace(cfg, ce_chunk=8))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_training_route_never_calls_the_served_attention(monkeypatch):
    """``loss_fn`` takes the plain attention backends by its own route,
    not by catching the kernel's refusal: the served ``attention`` is
    never called under it."""
    cfg = get_arch("smollm-360m").make_reduced()
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))

    def served(*a, **k):
        raise AssertionError("the training route called the served "
                             "attention")

    monkeypatch.setattr(tf, "attention", served)
    toks = torch.zeros(1, 6, dtype=torch.long)
    loss = tf.loss_fn(params, toks, toks, cfg)
    assert torch.isfinite(loss)
    with pytest.raises(AssertionError, match="served attention"):
        tf.forward(params, toks, cfg)


# ---------------------------------------------------------------------------
# token shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab", [200, 49_152, 151_936, 1 << 24])
def test_token_shards_are_byte_equal_to_the_reference(tmp_path, vocab):
    ids = np.random.default_rng(vocab).integers(0, vocab, 5000)
    tokens.write_token_shard(tmp_path / "port.ctok", ids, vocab)
    ref_tokens.write_token_shard(tmp_path / "ref.ctok", ids, vocab)
    with tokens.TokenShardWriter(tmp_path / "two.ctok", vocab) as w:
        w.append(ids[:1234])
        w.append(ids[1234:])
    want = (tmp_path / "ref.ctok").read_bytes()
    assert (tmp_path / "port.ctok").read_bytes() == want
    assert (tmp_path / "two.ctok").read_bytes() == want
    with pytest.raises(ValueError, match="vocab"):
        tokens.write_token_shard(tmp_path / "bad.ctok", [vocab], vocab)


@pytest.mark.parametrize("use_pgfuse", [False, True])
def test_token_reader_reads_what_the_reference_reads(tmp_path, use_pgfuse):
    ids = np.random.default_rng(2).integers(0, 151_936, 20_000)
    path = str(tmp_path / "t.ctok")
    ref_tokens.write_token_shard(path, ids, 151_936)
    kw = dict(use_pgfuse=use_pgfuse, pgfuse_block_size=1 << 12)
    r, rr = tokens.TokenShardReader(path, **kw), \
        ref_tokens.TokenShardReader(path, **kw)
    try:
        assert (r.b, r.vocab, r.n_tokens) == (3, 151_936, 20_000)
        np.testing.assert_array_equal(r.read_tokens(17, 300), ids[17:317])
        np.testing.assert_array_equal(r.read_packed(5, 9),
                                      rr.read_packed(5, 9))
        for packed in (False, True):
            got = list(r.batches(4, 63, n_steps=3, seed=1, packed=packed))
            want = list(rr.batches(4, 63, n_steps=3, seed=1, packed=packed))
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        # a packed batch decoded by K1's wrapper (plain version on the
        # CPU) is the host-decoded window
        packed = next(r.batches(4, 63, n_steps=1, seed=1, packed=True))
        host = next(r.batches(4, 63, n_steps=1, seed=1))
        dec = compbin_decode(torch.from_numpy(packed.reshape(-1).copy()), 3)
        np.testing.assert_array_equal(dec.numpy().reshape(4, 64), host)
        assert (r.pgfuse_stats() is None) == (not use_pgfuse)
    finally:
        r.close()
        rr.close()
    with open(tmp_path / "junk", "wb") as f:
        f.write(b"XXXX" + bytes(20))
    with pytest.raises(ValueError, match="not a token shard"):
        tokens.TokenShardReader(str(tmp_path / "junk"))


# ---------------------------------------------------------------------------
# the training driver
# ---------------------------------------------------------------------------

def test_lm_batches_equal_the_reference(tmp_path):
    cfg = get_arch("qwen2-moe-a2.7b").make_reduced()
    rcfg = ref_get_arch("qwen2-moe-a2.7b").make_reduced()
    got = train._lm_batches(cfg, 3, 16, str(tmp_path), True, device=CPU)
    want = ref_train._lm_batches(rcfg, 3, 16, str(tmp_path), True)
    try:
        for _ in range(3):
            a, b = next(got), next(want)
            assert set(a) == set(b) == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == torch.int64 and a[k].shape == (3, 16)
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    finally:
        got.close()
        want.close()
    assert got.reader.n_tokens == 200_000


def _ref_lm_state(arch, rcfg, cfg, opt_kw):
    rinit, rstep = ref_train._make_step(arch, rcfg, RefAdamWConfig(**opt_kw),
                                        "lm", False)
    rparams = rinit(jax.random.key(0))
    rstate = {"params": rparams,
              "opt": ref_adamw_init(rparams, RefAdamWConfig(**opt_kw))}
    tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)
    state = {"params": transformer_params_from_numpy(tonp(rparams), cfg,
                                                     device=CPU),
             "opt": adamw_state_from_numpy(tonp(rstate["opt"]), device=CPU)}
    return rstate, rstep, state


@pytest.mark.parametrize("arch,steps", [("smollm-360m", 10),
                                        ("qwen2-moe-a2.7b", 4)])
def test_lm_steps_match_the_reference(tmp_path, arch, steps):
    """The driver's step on the driver's batches from the JAX package's
    weights and optimizer state: losses step by step within rtol 1e-5;
    each param at the end within 1 % (L2) of the distance the JAX
    package's steps moved it, as ``chip_smoke.py::check_restart`` holds
    a restart: AdamW's m / sqrt(v) turns a near-zero gradient's last-bit
    difference into up to ``lr`` of movement an element."""
    cfg, rcfg = get_arch(arch).make_reduced(), \
        ref_get_arch(arch).make_reduced()
    opt_kw = dict(lr=1e-3, warmup_steps=10, total_steps=steps,
                  master_f32=True)
    rstate, rstep, state = _ref_lm_state(arch, rcfg, cfg, opt_kw)
    start = {k: np.asarray(v) for k, v in _flat(rstate["params"]).items()}
    _, step = train._make_step(arch, cfg, AdamWConfig(**opt_kw), "lm",
                               device=CPU)
    got = train._lm_batches(cfg, 4, 16, str(tmp_path), True, device=CPU)
    want = ref_train._lm_batches(rcfg, 4, 16, str(tmp_path), True)
    losses, ref_losses, calls = [], [], []
    try:
        with recorded_routing(calls):
            for _ in range(steps):
                state, met = step(state, next(got))
                rstate, rmet = rstep(rstate, next(want))
                losses.append(float(met["loss"]))
                ref_losses.append(float(rmet["loss"]))
    finally:
        got.close()
        want.close()
    if cfg.moe:
        assert_margins(calls, cfg.top_k)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    mine = _flat(state["params"])
    for k, v in _flat(rstate["params"]).items():
        v = np.asarray(v)
        moved = np.linalg.norm(v - start[k])
        assert np.linalg.norm(mine[k].numpy() - v) <= 1e-2 * moved, k


def test_cli_trains_the_moe_lm_and_restarts(tmp_path, caplog):
    """``--arch qwen2-moe-a2.7b --reduced``: 8 steps ending with the
    ``done:`` line; a run with a failure injected at step 5 restores the
    step-4 checkpoint, replays one step and ends at step 8.  (The
    trainer checkpoints no data position, in either package: the steps
    after the restore draw the next windows, so only the losses before
    the failure equal the uninjected run's.)"""
    kw = dict(steps=8, reduced=True, device=CPU, batch=2, seq=16,
              ckpt_every=4)
    with caplog.at_level(logging.INFO, logger="repro_torch.train"):
        clean = train.train("qwen2-moe-a2.7b", workdir=str(tmp_path / "a"),
                            **kw)
    assert any(r.message.startswith("done:") for r in caplog.records)
    assert len(clean["losses"]) == 8 and np.isfinite(clean["losses"]).all()
    hurt = train.train("qwen2-moe-a2.7b", workdir=str(tmp_path / "b"),
                       inject_failure_at=5, **kw)
    assert int(hurt["state"]["opt"]["step"]) == 8
    assert len(hurt["losses"]) == 9 and np.isfinite(hurt["losses"]).all()
    np.testing.assert_allclose(hurt["losses"][:5], clean["losses"][:5],
                               rtol=1e-6)


def test_cli_lm_flags(tmp_path):
    train.main(["--arch", "smollm-360m", "--reduced", "--device", CPU,
                "--steps", "2", "--batch", "2", "--seq", "8",
                "--workdir", str(tmp_path)])
    assert os.path.exists(tmp_path / "tokens.ctok")
    assert os.path.isdir(tmp_path / "ckpt_smollm-360m")


# ---------------------------------------------------------------------------
# checkpoints of an LM training state, across packages
# ---------------------------------------------------------------------------

def _bits(x) -> tuple:
    if isinstance(x, torch.Tensor):
        name = "bfloat16" if x.dtype == torch.bfloat16 else \
            str(x.numpy().dtype)
        raw = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x
               ).numpy().tobytes()
        return name, tuple(x.shape), raw
    a = np.asarray(x)
    name = "bfloat16" if a.dtype == ml_dtypes.bfloat16 else str(a.dtype)
    return name, a.shape, a.tobytes()


def _assert_bit_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert _bits(fa[k]) == _bits(fb[k]), k


def _lm_states(arch):
    """An LM training state (bf16 params, f32 router, f32 master and
    moments) in both packages, equal leaf for leaf."""
    rcfg, cfg, rparams, params = _ref_and_port(arch, dtype=torch.bfloat16)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=4, master_f32=True)
    rstate = {"params": rparams,
              "opt": ref_adamw_init(rparams, RefAdamWConfig(**kw))}
    state = {"params": params, "opt": adamw_init(params, AdamWConfig(**kw))}
    return rstate, state


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-moe-a2.7b"])
def test_lm_state_checkpoints_cross_restore(tmp_path, arch):
    rstate, state = _lm_states(arch)
    _assert_bit_equal(state, rstate)
    assert state["params"]["layers"]["wq"].dtype == torch.bfloat16
    a = ref_ck.save(str(tmp_path / "ref"), 3, rstate)
    b = ck.save(str(tmp_path / "port"), 3, state)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert open(os.path.join(a, name), "rb").read() == \
            open(os.path.join(b, name), "rb").read(), name
    step, got = ck.restore_latest(str(tmp_path / "ref"), state)
    assert step == 3
    _assert_bit_equal(got, rstate)
    step, rgot = ref_ck.restore_latest(str(tmp_path / "port"), rstate)
    assert step == 3
    _assert_bit_equal(rgot, state)
