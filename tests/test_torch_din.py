"""DIN through the port against the JAX package, on the CPU: the config
and registry, ``embed_items`` (padding, in-range and clamped ids),
``forward``, ``score_candidates``, ``loss_fn`` and its gradients on the
JAX package's own weights (``convert.din_params_from_numpy``), the
training CLI's batches and steps, ``serve_din``'s draws and the
analytic FLOPs of every cell.

Two configs: the reduced one and the published widths with a small
catalog (``WIDE``: embed 18, seq 100, attention MLP 80-40, final MLP
200-80, 1000 items).  Tolerances: ids and gathered rows equal; logits
and the loss within 1e-5; gradients within rtol 1e-4, atol 1e-6 x
max|g| of the JAX package's; after 10 steps each param within 1 % (L2)
of the distance the JAX package's steps moved it."""

import _torch_env  # noqa: F401  (first: one torch thread)
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as ref_serve
import repro.launch.train as ref_train
from repro.configs import all_cells as ref_all_cells
from repro.configs import get_arch as ref_get_arch
from repro.launch import model_flops as ref_flops
from repro.models.recsys import din as ref_din
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro_torch import configs
from repro_torch.configs import get_arch
from repro_torch.convert import adamw_state_from_numpy, din_params_from_numpy
from repro_torch.launch import model_flops, serve, train
from repro_torch.models.recsys import din
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves, tree_map

CPU = "cpu"
TOL = 1e-5
GRAD_TOL = (1e-4, 1e-6)
#: the published widths over a small catalog
WIDE = dict(name="din-wide", embed_dim=18, seq_len=100, n_items=1000,
            n_cates=10_000, attn_mlp=(80, 40), mlp=(200, 80))
CFGS = ["reduced", "wide"]


def _cfgs(which):
    if which == "reduced":
        return get_arch("din").make_reduced(), ref_get_arch("din").make_reduced()
    return din.DINConfig(**WIDE), ref_din.DINConfig(**WIDE)


def _pair(which):
    cfg, rcfg = _cfgs(which)
    rparams = ref_din.init_params(rcfg, jax.random.key(0))
    params = din_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), device=CPU)
    return cfg, rcfg, params, rparams


def _batch(cfg, b: int, seed: int = 1) -> dict:
    """A click batch with padding (-1) history ids and 0/1 labels, as
    numpy int64 / float32."""
    rng = np.random.default_rng(seed)
    return {"hist_items": rng.integers(-1, cfg.n_items, (b, cfg.seq_len)),
            "hist_cates": rng.integers(0, cfg.n_cates, (b, cfg.seq_len)),
            "cand_item": rng.integers(0, cfg.n_items, b),
            "cand_cate": rng.integers(0, cfg.n_cates, b),
            "labels": rng.integers(0, 2, b).astype(np.float32)}


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {kk: v for k in sorted(tree)
                for kk, v in _flat(tree[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def test_config_and_registry_mirror_the_reference():
    spec, ref_spec = get_arch("din"), ref_get_arch("din")
    assert (spec.arch_id, spec.family, spec.citation) == \
        (ref_spec.arch_id, ref_spec.family, ref_spec.citation)
    for make in ("make_config", "make_reduced"):
        a, b = getattr(spec, make)(), getattr(ref_spec, make)()
        for f in dataclasses.fields(b):
            if f.name != "dtype":
                assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert a.dtype == torch.float32 and a.d_item == b.d_item
    assert set(spec.shapes) == set(ref_spec.shapes) == {
        "train_batch", "serve_p99", "serve_bulk", "retrieval_cand"}
    assert configs.ARCH_IDS == __import__(
        "repro.configs", fromlist=["x"]).ARCH_IDS
    assert configs.all_cells() == ref_all_cells() and \
        len(configs.all_cells()) == 40


@pytest.mark.parametrize("which", CFGS)
def test_init_params_mirror_the_reference(which):
    cfg, rcfg = _cfgs(which)
    p = din.init_params(cfg, torch.Generator().manual_seed(0))
    r = ref_din.init_params(rcfg, jax.random.key(0))
    fp, fr = _flat(p), _flat(r)
    assert sorted(fp) == sorted(fr)
    for k, v in fr.items():
        assert tuple(fp[k].shape) == v.shape and fp[k].dtype == torch.float32
    # the tables at scale 0.01, truncated at two standard deviations
    t = p["item_table"]
    assert float(t.abs().max()) <= 0.02 + 1e-7
    assert abs(float(t.std()) - 0.0088) < 0.001
    for k, v in fp.items():
        if k.endswith("_b"):
            assert not v.any(), k


# (name, item ids, category ids) for n_items 1000, n_cates 32 (reduced)
# or 10_000 (wide): ids past either table read its last row.  The JAX
# package holds ids as int32 (x64 off), so the ids it is given fit it
EMBED_CASES = {
    "padding": ([-1, -1, 3], [5, -1, 0]),
    "in_range": ([0, 7, 999], [0, 31, 1]),
    "clamped_at_or_above_n": ([1000, 1001, 2**31 - 1],
                              [32, 10_000, 2**31 - 1]),
}


@pytest.mark.parametrize("which", CFGS)
@pytest.mark.parametrize("case", list(EMBED_CASES))
def test_embed_items_equals_the_reference(which, case):
    """Equal rows, padding zero; an id at or above ``n_items`` (or a
    category id at or above ``n_cates``) gives the last row, as the JAX
    package's gather clamps it (no raise, no device assert)."""
    cfg, rcfg, params, rparams = _pair(which)
    items, cates = (np.array(x, np.int64) for x in EMBED_CASES[case])
    got = din.embed_items(params, torch.from_numpy(items),
                          torch.from_numpy(cates)).numpy()
    want = np.asarray(ref_din.embed_items(rparams, jnp.asarray(items),
                                          jnp.asarray(cates)))
    np.testing.assert_array_equal(got, want)
    table = params["item_table"].numpy()
    for i, item in enumerate(items):
        if item >= cfg.n_items:
            np.testing.assert_array_equal(got[i, :cfg.embed_dim], table[-1])
        if item < 0:
            assert not got[i].any()
    # int64 ids past int32 clamp as well (the port keeps ids int64)
    wide = din.embed_items(params, torch.tensor([2**40]),
                           torch.tensor([2**40])).numpy()
    np.testing.assert_array_equal(
        wide[0], np.concatenate([table[-1], params["cate_table"][-1]]))


@pytest.mark.parametrize("which", CFGS)
def test_forward_equals_the_reference(which):
    cfg, rcfg, params, rparams = _pair(which)
    batch = _batch(cfg, 16)
    got = din.forward(params, _t(batch), cfg).numpy()
    want = np.asarray(jax.jit(ref_din.forward, static_argnums=2)(
        rparams, _j(batch), rcfg))
    assert got.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("which", CFGS)
def test_score_candidates_equals_the_reference(which):
    cfg, rcfg, params, rparams = _pair(which)
    rng = np.random.default_rng(2)
    batch = {"hist_items": rng.integers(-1, cfg.n_items, cfg.seq_len),
             "hist_cates": rng.integers(0, cfg.n_cates, cfg.seq_len),
             "cand_items": rng.integers(0, cfg.n_items + 5, 64),
             "cand_cates": rng.integers(0, cfg.n_cates, 64)}
    got = din.score_candidates(params, _t(batch), cfg).numpy()
    want = np.asarray(jax.jit(ref_din.score_candidates, static_argnums=2)(
        rparams, _j(batch), rcfg))
    assert got.shape == (64,)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("which", CFGS)
def test_loss_and_grads_equal_the_reference(which):
    cfg, rcfg, params, rparams = _pair(which)
    batch = _batch(cfg, 32)
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = din.loss_fn(p, _t(batch), cfg)
    grads = dict(zip(_flat(p), torch.autograd.grad(loss, tree_leaves(p))))
    rloss, rgrads = jax.jit(jax.value_and_grad(ref_din.loss_fn),
                            static_argnums=2)(rparams, _j(batch), rcfg)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=TOL)
    rtol, share = GRAD_TOL
    for k, want in _flat(rgrads).items():
        want = np.asarray(want)
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=rtol,
                                   atol=share * np.abs(want).max(),
                                   err_msg=k)


def test_din_batches_equal_the_reference():
    cfg = get_arch("din").make_reduced()
    rcfg = ref_get_arch("din").make_reduced()
    got = train._din_batches(cfg, 5, device=CPU)
    want = ref_train._din_batches(rcfg, 5)
    for _ in range(3):
        a, b = next(got), next(want)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == (torch.float32 if k == "labels"
                                  else torch.int64), k
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
        assert -1 <= int(a["hist_items"].min()) and \
            int(a["hist_items"].max()) < cfg.n_items


def test_serve_din_draws_and_logits_equal_the_reference(monkeypatch):
    """The JAX package's ``serve_din`` with every drawn array recorded
    (its ``jnp.asarray``), against the port's with every batch recorded
    (its ``forward``): the same ints in the same order, and on the JAX
    package's weights the same logits within 1e-5."""
    rcfg = ref_get_arch("din").make_reduced()
    cfg = get_arch("din").make_reduced()
    drawn = []

    class Recording:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def asarray(x):
            drawn.append(np.asarray(x))
            return jnp.asarray(x)

    monkeypatch.setattr(ref_serve, "jnp", Recording())
    ref_serve.serve_din(rcfg, batch=3, n_requests=4)
    monkeypatch.undo()
    assert len(drawn) == 4 * 4
    seen, forward = [], din.forward

    def recording(p, b, c):
        seen.append({k: v.numpy().copy() for k, v in b.items()})
        return forward(p, b, c)

    monkeypatch.setattr(din, "forward", recording)
    rparams = ref_din.init_params(rcfg, jax.random.key(0))
    params = din_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), device=CPU)
    logits, timings = serve.serve_din(cfg, batch=3, n_requests=4, device=CPU,
                                      params=params)
    got = [v for b in seen for v in b.values()]
    assert [list(b) for b in seen] == [["hist_items", "hist_cates",
                                        "cand_item", "cand_cate"]] * 4
    for a, b in zip(got, drawn, strict=True):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    for i in range(4):
        want = ref_din.forward(rparams, {k: jnp.asarray(v)
                                         for k, v in seen[i].items()}, rcfg)
        np.testing.assert_allclose(logits[i], np.asarray(want), rtol=TOL,
                                   atol=TOL)
    assert logits.shape == (4, 3) and len(timings["latencies_s"]) == 4
    assert timings["p99_ms"] >= timings["p50_ms"] > 0


def _ref_state(rcfg, cfg, opt_kw):
    rinit, rstep = ref_train._make_step("din", rcfg,
                                        RefAdamWConfig(**opt_kw), "recsys",
                                        False)
    rparams = rinit(jax.random.key(0))
    rstate = {"params": rparams,
              "opt": ref_adamw_init(rparams, RefAdamWConfig(**opt_kw))}
    tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)
    state = {"params": din_params_from_numpy(tonp(rparams), device=CPU),
             "opt": adamw_state_from_numpy(tonp(rstate["opt"]), device=CPU)}
    return rstate, rstep, state


@pytest.mark.parametrize("which", CFGS)
def test_steps_match_the_reference(which):
    """10 steps of the CLI's step on the CLI's batches from the
    JAX package's weights and optimizer state: losses within rtol 1e-5,
    lr equal, each param at the end within 1 % (L2) of the distance the
    JAX package's steps moved it (AdamW's m / sqrt(v) turns a near-zero
    gradient's last-bit difference into up to ``lr`` of movement)."""
    cfg, rcfg = _cfgs(which)
    opt_kw = dict(lr=1e-3, warmup_steps=10, total_steps=10, master_f32=True)
    rstate, rstep, state = _ref_state(rcfg, cfg, opt_kw)
    start = {k: np.asarray(v) for k, v in _flat(rstate["params"]).items()}
    _, step = train._make_step("din", cfg, AdamWConfig(**opt_kw), "recsys",
                               device=CPU)
    got, want = (train._din_batches(cfg, 16, device=CPU),
                 ref_train._din_batches(rcfg, 16))
    losses, ref_losses = [], []
    for _ in range(10):
        state, met = step(state, next(got))
        rstate, rmet = rstep(rstate, next(want))
        losses.append(float(met["loss"]))
        ref_losses.append(float(rmet["loss"]))
        np.testing.assert_allclose(float(met["lr"]), float(rmet["lr"]),
                                   rtol=1e-6)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert int(state["opt"]["step"]) == 10
    mine = _flat(state["params"])
    for k, v in _flat(rstate["params"]).items():
        v = np.asarray(v)
        moved = np.linalg.norm(v - start[k])
        assert moved > 0, k
        assert np.linalg.norm(mine[k].numpy() - v) <= 1e-2 * moved, k


def test_cli_trains_din_and_restarts_bit_for_bit(tmp_path, caplog):
    """``--arch din --reduced``: 10 steps ending with the ``done:`` line;
    a run with a failure injected at step 6 restores the step-4
    checkpoint and steps on.  The trainer checkpoints no data position
    (in either package), so after the restore it draws the next batches:
    its last 6 steps are the step-4 checkpoint of the uninjected run
    stepped on the 8th to 13th batches, and with one intra-op thread
    they equal that replay bit for bit (losses and final state)."""
    kw = dict(steps=10, reduced=True, device=CPU, batch=16, ckpt_every=4)
    with caplog.at_level(logging.INFO, logger="repro_torch.train"):
        clean = train.train("din", workdir=str(tmp_path / "a"), **kw)
    assert any(r.message.startswith("done:") for r in caplog.records)
    assert len(clean["losses"]) == 10 and np.isfinite(clean["losses"]).all()
    hurt = train.train("din", workdir=str(tmp_path / "b"),
                       inject_failure_at=6, **kw)
    assert int(hurt["state"]["opt"]["step"]) == 10
    assert len(hurt["losses"]) == 12
    assert hurt["losses"][:6] == clean["losses"][:6]
    from repro_torch import checkpoint as ck
    state = ck.restore(str(tmp_path / "a" / "ckpt_din"), 4, clean["state"])
    cfg = get_arch("din").make_reduced()
    _, step = train._make_step(
        "din", cfg, AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=10,
                                master_f32=True), "recsys", device=CPU)
    gen = train._din_batches(cfg, 16, device=CPU)
    batches = [next(gen) for _ in range(13)]
    losses = []
    for b in batches[7:]:
        state, met = step(state, b)
        losses.append(float(met["loss"]))
    assert losses == hurt["losses"][6:]
    for a, b in zip(tree_leaves(state), tree_leaves(hurt["state"]),
                    strict=True):
        assert torch.equal(a, b)


def test_cli_din_flags(tmp_path, caplog):
    """``python -m repro_torch.launch.train --arch din --reduced --device
    cpu --steps 3 [--compress-grads]`` and ``python -m
    repro_torch.launch.serve --arch din --reduced --device cpu
    --requests 4`` run and log the JAX package's lines; the training
    CLI leaves no process group behind."""
    import torch.distributed as dist
    with caplog.at_level(logging.INFO):
        for extra in ([], ["--compress-grads"]):
            train.main(["--arch", "din", "--reduced", "--device", CPU,
                        "--steps", "3", "--batch", "4", "--workdir",
                        str(tmp_path / str(len(extra)))] + extra)
            assert not dist.is_initialized()
        serve.main(["--arch", "din", "--reduced", "--device", CPU,
                    "--requests", "4", "--batch", "2"])
    text = [r.getMessage() for r in caplog.records]
    assert sum(m.startswith("done:") for m in text) == 2
    assert any(m.startswith("DIN batch=2: p50") and m.endswith("(3 reqs)")
               for m in text)


@pytest.mark.parametrize("cell", ref_all_cells(), ids="/".join)
def test_model_flops_equal_the_reference(cell):
    arch, shape = cell
    assert model_flops.model_flops(arch, shape) == \
        ref_flops.model_flops(arch, shape)
