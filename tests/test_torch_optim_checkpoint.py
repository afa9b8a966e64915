"""AdamW, checkpoints and the resilient trainer: the port's
``repro_torch.optim`` / ``repro_torch.checkpoint`` /
``repro_torch.distributed.fault_tolerance`` against the JAX package's on
the same numpy inputs.

AdamW: one step and 15 steps on the same grads within f32 rtol 1e-6 of
``repro.optim.adamw_update`` (the schedule, bias corrections and clip
scale are float32 on both sides; transcendental functions may differ by
an ulp).  Checkpoints: written by either package, restored by the other
bit for bit (bf16 included), manifests byte-equal.  The trainer: an
injected failure plus restore ends bit-equal to an uninjected run (CPU,
plain path, deterministic)."""

import _torch_env  # noqa: F401  (first: one torch thread)
import itertools
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ck
from repro.distributed.fault_tolerance import \
    ResilientTrainer as RefResilientTrainer
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import cosine_schedule as ref_cosine_schedule
from repro_torch import checkpoint as ck
from repro_torch.convert import adamw_state_from_numpy, adamw_state_to_numpy
from repro_torch.distributed.fault_tolerance import (ResilientTrainer,
                                                     StragglerMonitor)
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, global_norm)

RTOL = 1e-6


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else \
        t.detach().numpy()


# ---------------------------------------------------------------------------
# AdamW against the JAX package
# ---------------------------------------------------------------------------

CONFIGS = {
    "default": dict(lr=1e-3, warmup_steps=4, total_steps=15),
    "clipped": dict(lr=0.1, clip_norm=1e-2, warmup_steps=0, total_steps=15,
                    weight_decay=0.0),
    "no_master": dict(lr=3e-3, warmup_steps=2, total_steps=15,
                      master_f32=False),
    "cosine_tail": dict(lr=1e-2, warmup_steps=3, total_steps=8,
                        min_lr_frac=0.2),
}


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_steps_equal_the_reference(name, bf16):
    """15 AdamW steps on the same random grads, f32 or bf16 params (with
    f32 master copies where the config keeps them): every step's
    params, moments, master, lr and grad norm within rtol 1e-6 (atol
    1e-7 for values that pass through zero; bf16 params compared after
    their rounding, bit for bit)."""
    kw = CONFIGS[name]
    rcfg, pcfg = RefAdamWConfig(**kw), AdamWConfig(**kw)
    rng = np.random.default_rng(7)
    p0 = {"w": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    rp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    pp = {k: _t(v, tdt) for k, v in p0.items()}
    rs, ps = ref_adamw_init(rp, rcfg), adamw_init(pp, pcfg)
    assert ps["step"].dtype == torch.int32 and ps["step"].ndim == 0
    assert ("master" in ps) == kw.get("master_f32", True)
    for i in range(15):
        g = {k: (rng.standard_normal(v.shape) * (10.0 if i % 4 == 0 else 0.3)
                 ).astype(np.float32) for k, v in p0.items()}
        rp, rs, rmet = ref_adamw_update(
            rp, {k: jnp.asarray(v) for k, v in g.items()}, rs, rcfg)
        pp, ps, pmet = adamw_update(pp, {k: _t(v) for k, v in g.items()},
                                    ps, pcfg)
        assert int(ps["step"]) == int(rs["step"]) == i + 1
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(pmet[key]), float(rmet[key]),
                                       rtol=RTOL)
        for k in p0:
            assert pp[k].dtype == tdt
            if bf16:
                got = _np(pp[k])
                want = np.asarray(rp[k]).astype(np.float32)
                assert np.array_equal(got, want), (i, k)
            else:
                np.testing.assert_allclose(_np(pp[k]), np.asarray(rp[k]),
                                           rtol=RTOL, atol=1e-7)
            for part in ("m", "v") + (("master",) if "master" in rs else ()):
                np.testing.assert_allclose(
                    _np(ps[part][k]), np.asarray(rs[part][k]),
                    rtol=RTOL, atol=1e-7, err_msg=f"{part}/{k} step {i}")


def test_adamw_state_carries_across_packages():
    """The JAX optimizer state through ``adamw_state_from_numpy``, one
    more step on both sides, equal; and back through
    ``adamw_state_to_numpy``."""
    kw = CONFIGS["default"]
    rcfg, pcfg = RefAdamWConfig(**kw), AdamWConfig(**kw)
    rng = np.random.default_rng(3)
    p0 = {"w0": rng.standard_normal((4, 2)).astype(np.float32)}
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    rs = ref_adamw_init(rp, rcfg)
    g = {"w0": rng.standard_normal((4, 2)).astype(np.float32)}
    rp, rs, _ = ref_adamw_update(rp, {"w0": jnp.asarray(g["w0"])}, rs, rcfg)
    ps = adamw_state_from_numpy(jax.tree_util.tree_map(np.asarray, rs),
                                device="cpu")
    pp = {"w0": _t(np.asarray(rp["w0"]))}
    g2 = rng.standard_normal((4, 2)).astype(np.float32)
    rp, rs, _ = ref_adamw_update(rp, {"w0": jnp.asarray(g2)}, rs, rcfg)
    pp, ps, _ = adamw_update(pp, {"w0": _t(g2)}, ps, pcfg)
    np.testing.assert_allclose(_np(pp["w0"]), np.asarray(rp["w0"]),
                               rtol=RTOL)
    back = adamw_state_to_numpy(ps)
    assert back["step"].dtype == np.int32 and int(back["step"]) == 2
    for part in ("m", "v", "master"):
        np.testing.assert_allclose(back[part]["w0"],
                                   np.asarray(rs[part]["w0"]), rtol=RTOL)


# the four non-compression cases of tests/test_optim.py, on the port

def test_adamw_converges_quadratic_bf16_params():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=5,
                      total_steps=200)
    params = {"w": torch.ones(8, dtype=torch.bfloat16) * 3}
    st = adamw_init(params, cfg)
    target = torch.arange(8, dtype=torch.float32) * 0.1
    for _ in range(200):
        p = params["w"].detach().requires_grad_()
        loss = torch.sum((p.float() - target) ** 2)
        (g,) = torch.autograd.grad(loss, [p])
        params, st, met = adamw_update(params, {"w": g}, st, cfg)
    err = float(torch.max(torch.abs(params["w"].float() - target)))
    assert err < 0.05
    # master copies keep f32 precision beyond bf16 resolution
    assert st["master"]["w"].dtype == torch.float32


def test_grad_clip_caps_update():
    cfg = AdamWConfig(lr=1.0, clip_norm=1e-3, warmup_steps=0, total_steps=10,
                      weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    st = adamw_init(params, cfg)
    g = {"w": torch.ones(4) * 1e6}
    _, _, met = adamw_update(params, g, st, cfg)
    assert float(met["grad_norm"]) > 1e5  # reported pre-clip


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    rcfg = RefAdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    lrs = [float(cosine_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(0, 101, 5)]
    assert lrs[0] == 0.0
    assert abs(lrs[2] - 1.0) < 0.01          # end of warmup
    assert abs(lrs[-1] - 0.1) < 0.01          # min lr
    assert all(a >= b - 1e-6 for a, b in zip(lrs[2:], lrs[3:]))  # decay
    want = [float(ref_cosine_schedule(rcfg, jnp.int32(s)))
            for s in range(0, 101, 5)]
    np.testing.assert_allclose(lrs, want, rtol=RTOL)


def test_global_norm():
    t = {"a": torch.ones(4) * 3, "b": torch.ones(9) * 4}
    np.testing.assert_allclose(float(global_norm(t)),
                               np.sqrt(4 * 9 + 9 * 16), rtol=1e-6)


def test_adamw_update_leaves_its_inputs_as_they_were():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=5)
    params = {"w": torch.ones(3)}
    st = adamw_init(params, cfg)
    before = {k: v.clone() for k, v in st["master"].items()}
    adamw_update(params, {"w": torch.ones(3)}, st, cfg)
    assert torch.equal(params["w"], torch.ones(3))
    assert int(st["step"]) == 0
    assert torch.equal(st["master"]["w"], before["w"])
    assert not st["m"]["w"].any()


# ---------------------------------------------------------------------------
# checkpoints: both directions, bit for bit
# ---------------------------------------------------------------------------

def _tree_np():
    """One tree as numpy: f32, bf16 (as ml_dtypes), int32 0-d, a list."""
    rng = np.random.default_rng(5)
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "b": rng.standard_normal(4).astype(ml_dtypes.bfloat16)},
            "opt": {"step": np.int32(7),
                    "m": [np.zeros(2, np.float32),
                          rng.standard_normal(3).astype(np.float32)]}}


def _as_ref(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _as_port(tree):
    def conv(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree_util.tree_map(conv, tree)


def _bits(x) -> tuple:
    """(dtype name, shape, raw bytes) of a leaf of either package."""
    if isinstance(x, torch.Tensor):
        name = "bfloat16" if x.dtype == torch.bfloat16 else \
            str(x.numpy().dtype)
        raw = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x
               ).numpy().tobytes()
        return name, tuple(x.shape), raw
    a = np.asarray(x)
    return str(a.dtype), a.shape, a.tobytes()


def _leaves(tree):
    return [leaf for _, leaf in sorted(
        jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0],
        key=lambda kv: jax.tree_util.keystr(kv[0]))]


def _assert_bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert _bits(x) == _bits(y)


def test_jax_written_checkpoint_restores_in_the_port(tmp_path):
    tree = _tree_np()
    ref_ck.save(str(tmp_path), 5, _as_ref(tree))
    step, got = ck.restore_latest(str(tmp_path), _as_port(tree))
    assert step == 5
    assert got["params"]["b"].dtype == torch.bfloat16
    assert got["opt"]["step"].dtype == torch.int32
    assert isinstance(got["opt"]["m"], list)
    _assert_bit_equal(got, tree)


def test_port_written_checkpoint_restores_in_jax(tmp_path):
    tree = _tree_np()
    ck.save(str(tmp_path), 9, _as_port(tree))
    step, got = ref_ck.restore_latest(str(tmp_path), _as_ref(tree))
    assert step == 9
    assert got["params"]["b"].dtype == jnp.bfloat16
    _assert_bit_equal(got, tree)


def test_manifests_and_files_are_byte_equal(tmp_path):
    tree = _tree_np()
    a = ref_ck.save(str(tmp_path / "ref"), 3, _as_ref(tree))
    b = ck.save(str(tmp_path / "port"), 3, _as_port(tree))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    keys = [e["key"] for e in json.load(open(os.path.join(b,
                                                          "manifest.json")))
            ["leaves"]]
    assert keys == ["opt/m/0", "opt/m/1", "opt/step", "params/b",
                    "params/w"]


def test_gcn_train_state_manifest_equals_the_reference(tmp_path):
    """The keys of a training state (``params/w0``, ``opt/m/w0``, ...)
    in the reference's order, and its optimizer state restored into the
    JAX package's structure."""
    kw = CONFIGS["default"]
    p = {"w0": np.ones((3, 2), np.float32), "b0": np.zeros(2, np.float32)}
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    pp = {k: _t(v) for k, v in p.items()}
    rstate = {"params": rp, "opt": ref_adamw_init(rp, RefAdamWConfig(**kw))}
    pstate = {"params": pp, "opt": adamw_init(pp, AdamWConfig(**kw))}
    a = ref_ck.save(str(tmp_path / "ref"), 1, rstate)
    b = ck.save(str(tmp_path / "port"), 1, pstate)
    assert open(os.path.join(a, "manifest.json"), "rb").read() == \
        open(os.path.join(b, "manifest.json"), "rb").read()
    _, got = ref_ck.restore_latest(str(tmp_path / "port"), rstate)
    _assert_bit_equal(got, pstate)


# the cases of tests/test_checkpoint.py, on the port

@pytest.fixture
def tree():
    return _as_port(_tree_np())


def test_roundtrip(tmp_path, tree):
    ck.save(str(tmp_path), 5, tree)
    step, got = ck.restore_latest(str(tmp_path), tree)
    assert step == 5
    _assert_bit_equal(got, tree)


def test_restore_latest_picks_max_and_ignores_tmp(tmp_path, tree):
    ck.save(str(tmp_path), 3, tree)
    ck.save(str(tmp_path), 11, jax.tree_util.tree_map(
        lambda x: x + 1, tree))
    os.makedirs(tmp_path / "step_00000099.tmp")  # crashed save
    step, got = ck.restore_latest(str(tmp_path), tree)
    assert step == 11
    assert int(got["opt"]["step"]) == 8


def test_gc_keeps_last_k(tmp_path, tree):
    for s in range(6):
        ck.save(str(tmp_path), s, tree, keep_last=2)
    steps = sorted(int(d[5:]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [4, 5]


def test_async_checkpointer(tmp_path, tree):
    ac = ck.AsyncCheckpointer(str(tmp_path), keep_last=3)
    ac.save(1, tree)
    ac.save(2, tree)   # waits for #1 internally
    ac.wait()
    assert ck.latest_step(str(tmp_path)) == 2


def test_async_save_takes_an_independent_copy(tmp_path, tree, monkeypatch):
    """A CPU tensor changed in place right after ``save`` returns must
    not reach the checkpoint: the writer holds its own copy."""
    import threading
    gate = threading.Event()
    real_save = ck.checkpointer.save

    def slow_save(*a, **kw):
        gate.wait(5)
        return real_save(*a, **kw)

    monkeypatch.setattr(ck.checkpointer, "save", slow_save)
    ac = ck.AsyncCheckpointer(str(tmp_path))
    want = tree["params"]["w"].clone()
    ac.save(1, tree)
    tree["params"]["w"].add_(100.0)       # an in-place optimizer update
    gate.set()
    ac.wait()
    _, got = ck.restore_latest(str(tmp_path), tree)
    assert torch.equal(got["params"]["w"], want)


def test_missing_leaf_raises(tmp_path, tree):
    ck.save(str(tmp_path), 1, {"params": tree["params"]})
    with pytest.raises(KeyError):
        ck.restore(str(tmp_path), 1, tree)


def test_restore_places_leaves_on_the_given_device(tmp_path, tree):
    ck.save(str(tmp_path), 2, tree)
    _, got = ck.restore_latest(str(tmp_path), tree, device="cpu")
    assert all(x.device == torch.device("cpu") for x in _leaves(got))
    _, got = ck.restore_latest(str(tmp_path), _tree_np())
    assert all(isinstance(x, torch.Tensor) for x in _leaves(got))
    _assert_bit_equal(got, tree)


# ---------------------------------------------------------------------------
# ResilientTrainer / StragglerMonitor: the cases of
# tests/test_fault_tolerance.py, on the port
# ---------------------------------------------------------------------------

def _step(state, batch):
    w = state["w"] - 0.1 * (state["w"] - batch)
    return {"w": w, "n": state["n"] + 1}, {"loss": torch.mean((w - batch) ** 2)}


def _state():
    return {"w": torch.zeros(4), "n": torch.tensor(0, dtype=torch.int32)}


def test_resilient_trainer_recovers_from_injected_failure(tmp_path):
    tr = ResilientTrainer(_step, _state(), ckpt_dir=str(tmp_path),
                          ckpt_every=5, max_retries=2)
    seen = []
    final = tr.run(itertools.repeat(torch.ones(4)), n_steps=20,
                   inject_failure_at=12,
                   on_metrics=lambda s, m: seen.append(s))
    # the run completed all 20 *effective* steps despite the failure
    assert int(final["n"]) == 20
    assert max(seen) == 20
    # steps 11..12 were re-run after restoring the step-10 checkpoint
    assert seen.count(11) == 2


def test_resilient_trainer_restart_from_latest(tmp_path):
    tr1 = ResilientTrainer(_step, _state(), ckpt_dir=str(tmp_path),
                           ckpt_every=5)
    tr1.run(itertools.repeat(torch.ones(4)), n_steps=10)
    # simulate a NEW JOB (relaunch): trainer picks up at step 10
    tr2 = ResilientTrainer(_step, _state(), ckpt_dir=str(tmp_path),
                           ckpt_every=5)
    assert tr2.start_step == 10
    final = tr2.run(itertools.repeat(torch.ones(4)), n_steps=15)
    assert int(final["n"]) == 15


@pytest.mark.parametrize("fail_at,every", [(12, 5), (5, 4), (3, 3)])
def test_injected_failure_ends_bit_equal_to_an_uninjected_run(
        tmp_path, fail_at, every):
    """Restore replays the lost steps from the checkpoint: on a constant
    batch (the full-graph regime) the final state is the uninjected
    run's bit for bit (the step is deterministic on the CPU), and the JAX
    package's trainer on the same schedule replays the same steps."""
    d = np.random.default_rng(fail_at).standard_normal(4).astype(np.float32)

    def batches():
        return itertools.repeat(torch.from_numpy(d))

    clean = ResilientTrainer(_step, _state(), ckpt_dir=str(tmp_path / "a"),
                             ckpt_every=every).run(batches(), n_steps=15)
    seen, ref_seen = [], []
    hurt = ResilientTrainer(_step, _state(), ckpt_dir=str(tmp_path / "b"),
                            ckpt_every=every).run(
        batches(), n_steps=15, inject_failure_at=fail_at,
        on_metrics=lambda s, m: seen.append(s))
    assert torch.equal(hurt["w"], clean["w"])
    assert int(hurt["n"]) == int(clean["n"]) == 15
    assert len(seen) == 15 + fail_at - (fail_at // every) * every
    ref_step = jax.jit(lambda st, b: (
        {"w": st["w"] - 0.1 * (st["w"] - b), "n": st["n"] + 1}, {}))
    ref_final = RefResilientTrainer(
        ref_step, {"w": jnp.zeros(4), "n": jnp.int32(0)},
        ckpt_dir=str(tmp_path / "r"), ckpt_every=every).run(
        itertools.repeat(jnp.asarray(d)), n_steps=15,
        inject_failure_at=fail_at, on_metrics=lambda s, m: ref_seen.append(s))
    assert seen == ref_seen
    np.testing.assert_allclose(hurt["w"].numpy(), np.asarray(ref_final["w"]),
                               rtol=RTOL)


def test_straggler_monitor_flags_slow_host():
    sm = StragglerMonitor(8, window=10, k=2.0, min_samples=3)
    rng = np.random.default_rng(0)
    for _ in range(10):
        t = rng.normal(1.0, 0.03, 8)
        t[5] = 2.8
        sm.record_step(t)
    assert sm.stragglers() == [5]
    assert sm.should_evict(5)
    assert not sm.should_evict(0)


def test_straggler_monitor_needs_evidence():
    sm = StragglerMonitor(4, min_samples=5)
    sm.record_step([1.0, 1.0, 1.0, 9.0])
    assert sm.stragglers() == []  # one sample is not evidence


def test_straggler_monitor_recovery():
    sm = StragglerMonitor(4, window=5, k=2.0, min_samples=3)
    for _ in range(5):
        sm.record_step([1.0, 1.0, 1.0, 5.0])
    assert sm.stragglers() == [3]
    for _ in range(5):  # host 3 recovers; window slides
        sm.record_step([1.0, 1.0, 1.0, 1.0])
    assert sm.stragglers() == []
