"""``chip_smoke.py``'s ``[din]`` phase on the CPU at the reduced DIN
config, so what the GPU run drives is what these tests ran, and a fault
planted in each of its checks makes it raise.

On the CPU the card's path and the plain CPU path are one code, so the
logits agree exactly and no kernel launches.  The planted faults:
served logits off by 1e-3 (``serve_din``'s and the bulk batch's check),
a wrong id out of the request decode (the ids check), retrieval scores
off (its check), a first-step loss or gradient off (the parity check), a
NaN loss (the finite check), a step that leaves the params where they were (the loss must fall on a
repeated batch), a lost restore (the restart check), a quantisation on
the wrong scale, a non-finite residual and a wrong int8 sum (the
compression checks)."""

from _torch_env import load_chip_smoke  # first: one torch thread
import functools

import numpy as np
import pytest
import torch


#: the reduced DIN at a few requests and small batches
SIZES = dict(requests=4, batch=8, bulk=64, candidates=64, train_batch=32,
             parity_batch=16)


@pytest.fixture(scope="module")
def smoke():
    return load_chip_smoke()


def _phase(smoke, tmp_path, **sizes):
    return smoke.phase_din("cpu", str(tmp_path), reduced=True,
                           sizes={**SIZES, **sizes})


def test_din_phase_on_cpu(smoke, tmp_path):
    r = _phase(smoke, tmp_path)
    assert r["k1_launches"] == 0 and r["packed"]["k1_launches"] == 0
    assert r["config"]["name"] == "din-reduced" and r["params"] == 10930
    s, p = r["serve"], r["packed"]
    assert s["max_abs_err"] == p["max_abs_err"] == 0.0
    assert s["rows_checked"] == 4 * 8 and len(s["latencies_s"]) == 4
    assert p["b"] == 2 and p["ids_per_request"] == 8 * 21
    assert p["ids_checked"] == 4 * 8 * 21
    assert p["wire_bytes"] == 4 * 8 * 21 * 2 and p["int32_bytes"] == \
        2 * p["wire_bytes"]
    assert r["bulk"]["max_abs_err"] == r["retrieval"]["max_abs_err"] == 0.0
    t = r["train"]
    assert len(t["losses"]) == 10 and np.isfinite(t["losses"]).all()
    assert t["first_loss_rel_err"] == 0.0
    assert len(t["repeated_batch_losses"]) == 3
    assert t["restart"]["loss_rel_err"] == 0.0
    assert t["parity"]["loss_rel_err"] == 0.0
    cp = t["compressed"]
    assert cp["backend"] == "gloo" and len(cp["ef_calls"]) == 3
    assert all(c["worst_residual_share"] <= 1.0 + 1e-5
               for c in cp["ef_calls"])
    assert cp["ef_calls"][0]["int8_bytes"] * 4 == \
        cp["ef_calls"][0]["f32_bytes"] == 4 * r["params"]
    smoke.log_din(r)


def _off(real, *args, **kw):
    logits, timings = real(*args, **kw)
    return logits + 1e-3, timings


def test_served_logits_check_detects_a_planted_fault(smoke, tmp_path,
                                                     monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(serve, "serve_din",
                        functools.partial(_off, serve.serve_din))
    with pytest.raises(AssertionError, match="request 0: max abs err"):
        _phase(smoke, tmp_path)


def test_bulk_logits_check_detects_a_planted_fault(smoke, monkeypatch):
    """The bulk batch's rows past the served batch: a fault there only."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.recsys import din
    cfg = get_arch("din").make_reduced()
    params = din.init_params(cfg, torch.Generator().manual_seed(0))
    real = serve.serve_din

    def bulk_off(cfg, *, batch, **kw):
        logits, timings = real(cfg, batch=batch, **kw)
        return (logits + 1e-3 if batch > 8 else logits), timings

    monkeypatch.setattr(serve, "serve_din", bulk_off)
    smoke.din_served(cfg, params, "cpu", batch=8, n_requests=2)
    with pytest.raises(AssertionError, match="max abs err"):
        smoke.din_served(cfg, params, "cpu", batch=64, n_requests=2)


def test_packed_ids_check_detects_a_wrong_decode(smoke, tmp_path,
                                                 monkeypatch):
    real = smoke.compbin_decode

    def off_by_one(packed, b):
        return real(packed, b) + 1

    off_by_one.launches = 0
    monkeypatch.setattr(smoke, "compbin_decode", off_by_one)
    with pytest.raises(AssertionError, match="differ from decode_ids"):
        _phase(smoke, tmp_path)


def test_retrieval_check_detects_a_planted_fault(smoke, tmp_path,
                                                 monkeypatch):
    """Scores off only in the timed call (600 candidates; the warm-up and
    the plain path score the first 512)."""
    from repro_torch.models.recsys import din
    real = din.score_candidates

    def off(params, batch, cfg):
        out = real(params, batch, cfg)
        return out + 1e-3 if batch["cand_items"].numel() > 512 else out

    monkeypatch.setattr(din, "score_candidates", off)
    with pytest.raises(AssertionError, match="retrieval scores"):
        _phase(smoke, tmp_path, candidates=600)


def test_parity_check_detects_a_planted_fault(smoke):
    exact = {"w": torch.tensor([1.0, -2.0, 3.0], dtype=torch.float64)}
    plain = {"w": torch.tensor([1.0, -2.0, 3.0 + 3e-7])}
    grads = {"w": plain["w"].clone()}
    r = smoke.din_parity_check(0.6931, 0.6931, grads, plain, exact)
    assert r["plain_relative_distance"] > 0
    with pytest.raises(AssertionError, match="first-step loss"):
        smoke.din_parity_check(0.6931 * (1 + 2e-5), 0.6931, grads, plain,
                               exact)
    grads["w"][0] += 1e-4
    with pytest.raises(AssertionError, match="first-step grad w"):
        smoke.din_parity_check(0.6931, 0.6931, grads, plain, exact)


def test_first_step_loss_check_detects_a_planted_fault(smoke, tmp_path,
                                                       monkeypatch):
    """The training route's loss off by 1e-4 of itself (the plain CPU
    path's forward, under ``no_grad``, is left alone)."""
    from repro_torch.models.recsys import din
    real = din.loss_fn

    def off(params, batch, cfg):
        loss = real(params, batch, cfg)
        return loss * (1 + 1e-4) if torch.is_grad_enabled() else loss

    monkeypatch.setattr(din, "loss_fn", off)
    with pytest.raises(AssertionError, match="first-step loss"):
        _phase(smoke, tmp_path)


def test_finite_loss_check_detects_a_nan(smoke, tmp_path, monkeypatch):
    """A training step whose loss is NaN (over fresh batches the only
    check on the losses is that they stay finite)."""
    from repro_torch.models.recsys import din
    real = din.loss_fn

    def nan(params, batch, cfg):
        loss = real(params, batch, cfg)
        return loss * float("nan") if torch.is_grad_enabled() else loss

    monkeypatch.setattr(din, "loss_fn", nan)
    with pytest.raises(AssertionError, match="nan"):
        _phase(smoke, tmp_path)


def test_loss_falls_check_detects_a_stuck_step(smoke, tmp_path,
                                               monkeypatch):
    """A step that leaves the params where they were."""
    from repro_torch.launch import train as tr
    real = tr.adamw_update

    def stuck(params, grads, opt, cfg):
        _, new_opt, met = real(params, grads, opt, cfg)
        return params, new_opt, met

    monkeypatch.setattr(tr, "adamw_update", stuck)
    with pytest.raises(AssertionError, match="does not fall"):
        _phase(smoke, tmp_path)
    with pytest.raises(AssertionError, match="does not fall"):
        smoke.check_loss_falls([0.69, 0.68, 0.68])


def test_restart_check_detects_a_lost_restore(smoke, tmp_path, monkeypatch):
    """A restore that hands back the running state instead of the
    checkpoint leaves the run a step ahead."""
    import repro_torch.checkpoint as ck

    def lost(real, ckpt_dir, state, **kw):
        step, _ = real(ckpt_dir, state, **kw)
        return step, state

    monkeypatch.setattr(ck, "restore_latest",
                        functools.partial(lost, ck.restore_latest))
    with pytest.raises(AssertionError, match="not the one it checkpointed"):
        _phase(smoke, tmp_path)


def _compress(smoke, grads: dict):
    """One checked ``ef_compress_psum`` call on a gloo world of one."""
    from repro_torch.launch import train as tr
    from repro_torch.optim import compression, ef_state_init
    calls = []
    with tr.process_group("cpu"), smoke.checked_ef(calls):
        compression.ef_compress_psum(grads, ef_state_init(grads),
                                     axis_size=1)
    return calls


def _grads():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(64, 18, generator=g),
            "b": torch.randn(5, generator=g) * 1e-3}


def test_ef_check_passes_and_detects_a_wrong_scale(smoke, monkeypatch):
    calls = _compress(smoke, _grads())
    assert len(calls) == 1 and calls[0]["leaves"] == 2
    assert 0.5 < calls[0]["worst_residual_share"] <= 1.0 + 1e-5
    from repro_torch.optim import compression
    real = compression._quantize

    def half_scale(x, levels, group):
        _, scale = real(x, levels, group)
        q = torch.clamp(torch.round(x / (scale / 2)), -levels, levels)
        return q.to(torch.int8), scale

    monkeypatch.setattr(compression, "_quantize", half_scale)
    with pytest.raises(AssertionError, match="beyond half the quantisation"):
        _compress(smoke, _grads())


def test_ef_check_detects_a_non_finite_residual(smoke):
    grads = _grads()
    grads["w"][3, 4] = float("nan")
    with pytest.raises(AssertionError, match="not finite"):
        _compress(smoke, grads)


def test_ef_check_detects_a_wrong_sum(smoke, monkeypatch):
    """An int8 sum that doubles what it was given (a collective counting a
    rank twice): the mean leaves the grid the residual was taken on."""
    import torch.distributed as dist
    real = dist.all_reduce

    def twice(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        out = real(t, op=op, group=group, async_op=async_op)
        if t.dtype == torch.int8:
            t.mul_(2)
        return out

    monkeypatch.setattr(dist, "all_reduce", twice)
    with pytest.raises(AssertionError, match="compressed mean off"):
        _compress(smoke, _grads())
