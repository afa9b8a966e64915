"""``chip_smoke.py``'s ``[moe]`` and ``[lm_train]`` phases on the CPU at
the reduced configs (f32), so what the GPU run drives is what these
tests ran, and a fault planted in each of their checks makes it raise.

On the CPU the kernel path and the plain path are one code: routing,
logits, the combine and the first step's loss and gradients agree
exactly, and no kernel launches.  The planted faults: a clear token
routed to another expert, a kept assignment moved, too many near ties
(the routing check); the kernel path's combine losing a message (the
logits, the combine check and the first step's parity); a lost restore
(the restart check); a step that does not move the params (the loss
must fall)."""

import dataclasses
import functools
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

MOE_KW = dict(batch=2, prompt_len=16, n_tokens=4, check_prompt_len=8,
              check_tokens=3, reduced=True)
#: the reduced LMs, 4 x 32 tokens a step
LM_MODELS = (("smollm-360m", None, 4, 32, 4, 5),
             ("qwen2-moe-a2.7b", None, 4, 32, 5, 6))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    path_before = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path_before
    return mod


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_moe_phase_on_cpu(smoke):
    out = smoke.phase_moe("cpu", **MOE_KW)
    assert set(out["models"]) == {"qwen2-moe-a2.7b", "dbrx-132b"}
    assert out["k3_launches"] == out["k2_launches"] == 0
    for arch, r in out["models"].items():
        assert r["layers"] == (6 if arch == "dbrx-132b" else 2)
        c = r["check"]
        assert c["routing"]["flips"] == c["routing"]["near_ties"] == 0
        assert c["routing"]["max_router_diff"] == 0.0
        assert c["logits_max_abs_err"] == 0.0 and c["token_flips"] == []
        assert c["rows_compared"] == 2 and c["combine_max_abs_err"] == 0.0
        assert r["tokens_per_s"] > 0 and r["prefill_capacity"] >= 1
        ids, n = r["combine_ids"]["prefill"]
        assert n == 2 * 16 and ids.numel() == n * r["top_k"]
        assert r["combine_ids"]["decode"][1] == 2
    smoke.log_moe(out)


def _records(smoke, arch="qwen2-moe-a2.7b", capacity_factor=None,
             tokens=24):
    """Two identical runs' routing records of one ``moe_ffn`` call."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    cfg = get_arch(arch).make_reduced()
    if capacity_factor:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = torch.randn(tokens, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    runs = []
    for _ in range(2):
        runs.append([])
        with smoke.recorded_moe(runs[-1]):
            tf.moe_ffn(x, lp, cfg)
    return cfg, runs[0], runs[1]


def test_routing_check_detects_a_clear_token_routed_otherwise(smoke):
    cfg, got, want = _records(smoke)
    assert smoke.check_moe_routing(got, want, cfg.top_k, cfg.e_pad,
                                   2)["flips"] == 0
    idx = got[0]["idx"].clone()
    probs = got[0]["probs"]
    # token 0's K-th choice swapped for its least likely expert
    idx[0, -1] = int(probs[0].argmin())
    got[0]["idx"] = idx
    with pytest.raises(AssertionError, match="routed to other experts"):
        smoke.check_moe_routing(got, want, cfg.top_k, cfg.e_pad, 2)


def test_routing_check_detects_a_moved_kept_assignment(smoke):
    cfg, got, want = _records(smoke, capacity_factor=0.5)
    keep = got[0]["keep"]
    assert 0 < int(keep.sum()) < keep.numel()      # drops happen
    # a smaller capacity drops assignments the plain path kept
    got[0]["capacity"] = want[0]["capacity"] = want[0]["capacity"]
    got[0]["capacity"] -= 1
    with pytest.raises(AssertionError):
        smoke.check_moe_routing(got, want, cfg.top_k, cfg.e_pad, 2)
    got[0]["capacity"] = want[0]["capacity"]
    got[0]["idx"] = got[0]["idx"].flip(0)        # other tokens per expert
    got[0]["probs"] = got[0]["probs"].flip(0)
    with pytest.raises(AssertionError):
        smoke.check_moe_routing(got, want, cfg.top_k, cfg.e_pad, 2)


def test_routing_check_bounds_the_near_ties(smoke, monkeypatch):
    """Routings closer to a tie than the paths' difference are counted;
    past ``MOE_TIE_SHARE`` of them the check fails, and a flipped one
    takes its batch row out of the logits comparison."""
    cfg, got, want = _records(smoke)
    noisy = dict(got[0], probs=got[0]["probs"] + 1.0)   # all near ties
    with pytest.raises(AssertionError, match="closer to a tie"):
        smoke.check_moe_routing([noisy], want, cfg.top_k, cfg.e_pad, 2)
    monkeypatch.setattr(smoke, "MOE_TIE_SHARE", 1.0)
    idx = got[0]["idx"].clone()
    idx[13, -1] = int(got[0]["probs"][13].argmin())
    r = smoke.check_moe_routing([dict(noisy, idx=idx)], want, cfg.top_k,
                                cfg.e_pad, 2)
    assert r["flips"] == 1 and r["rows_flipped"] == [1]
    assert r["near_ties"] == 24


def _dropping_sum(msgs, ids, n):
    """The kernel path's combine losing its last message (the plain path
    keeps it)."""
    from repro_torch.kernels.segment_sum import segment_sum_ref
    ids = ids.clone()
    ids[-1] = -1
    return segment_sum_ref(msgs, ids, n)


def test_moe_check_detects_a_lost_combine_message(smoke, monkeypatch):
    from repro_torch.models import transformer as tf
    monkeypatch.setattr(tf, "segment_sum", _dropping_sum)
    # the next layer's router sees the difference first, else the logits
    with pytest.raises(AssertionError,
                       match="closer to a tie|routed to other|logits differ"):
        smoke.phase_moe("cpu", **MOE_KW)


def test_combine_check_detects_a_wrong_kernel(smoke, monkeypatch):
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch("dbrx-132b").make_reduced(),
                              n_layers=1)
    calls = []
    from repro_torch.launch.serve import serve_lm
    with smoke.recorded_moe(calls):
        serve_lm(cfg, batch=2, prompt_len=8, n_tokens=2, device="cpu")
    assert smoke.check_moe_combine(calls, "dbrx") == 0.0
    monkeypatch.setattr(smoke, "segment_sum", _dropping_sum)
    with pytest.raises(AssertionError):
        smoke.check_moe_combine(calls, "dbrx")


def test_lm_train_phase_on_cpu(smoke, tmp_path, one_thread):
    out = smoke.phase_lm_train("cpu", str(tmp_path), models=LM_MODELS,
                               reduced=True)
    assert out["k2_launches"] == out["k2_grad_launches"] == 0
    for arch, r in out["models"].items():
        assert len(r["losses"]) == 10
        assert np.mean(r["losses"][-3:]) < np.mean(r["losses"][:3])
        rs = r["restart"]
        assert rs["loss_rel_err"] == 0.0
        assert all(d["share"] == 0.0 for d in rs["drift"].values())
        par = r["parity"]
        assert par["loss"] == par["plain_loss"]
        if arch == "qwen2-moe-a2.7b":
            assert r["combine_ids"][1] == 4 * 32
            assert par["routing"]["kernel_vs_plain"]["max_router_diff"] == 0
            assert par["routing"]["float64_vs_plain"]["flips"] == 0
            assert 0 < par["plain_relative_distance"] < 1e-4
        else:
            assert all(e == 0 for e in par["grad_max_abs_err"].values())
    smoke.log_lm_train(out)


def test_lm_train_restart_checkpoints_under_its_root(smoke, tmp_path,
                                                    one_thread):
    """The restart writes its checkpoints under ``ckpt_root`` (a RAM file
    system on the card's machine: ``LM_CKPT_ROOT``), removes the one it
    resumed from once the next step is done, leaves none behind, and
    records the bytes it wrote; ``LM_TRAIN`` restarts both LMs."""
    root = tmp_path / "ram"
    root.mkdir()
    out = smoke.phase_lm_train("cpu", str(tmp_path), reduced=True,
                               ckpt_root=str(root), models=(
                                   ("qwen2-moe-a2.7b", None, 4, 32, 5, 6),))
    rs = out["models"]["qwen2-moe-a2.7b"]["restart"]
    assert rs["ckpt_root"] == str(root) and rs["checkpoints"] == 2
    assert rs["loss_rel_err"] == 0.0
    state = out["models"]["qwen2-moe-a2.7b"]["state_bytes"]
    assert state < rs["checkpoint_bytes"] < state + (1 << 16)   # + headers
    assert rs["bytes_written"] == 2 * rs["checkpoint_bytes"]
    assert list(root.iterdir()) == []
    assert all(m[4] and m[5] for m in smoke.LM_TRAIN)
    smoke.log_lm_train(out)


def test_lm_train_parity_detects_a_lost_combine_message(smoke, tmp_path,
                                                        monkeypatch):
    from repro_torch.models import transformer as tf
    monkeypatch.setattr(tf, "segment_sum", _dropping_sum)
    with pytest.raises(AssertionError, match="first-step"):
        smoke.phase_lm_train("cpu", str(tmp_path), models=LM_MODELS[1:],
                             reduced=True)


def test_lm_train_restart_detects_a_lost_restore(smoke, monkeypatch,
                                                 tmp_path):
    """A restore that hands back the running state instead of the
    checkpoint leaves the run a step ahead."""
    import repro_torch.checkpoint as ck

    def lost(real, ckpt_dir, state, **kw):
        step, _ = real(ckpt_dir, state, **kw)
        return step, state

    monkeypatch.setattr(ck, "restore_latest",
                        functools.partial(lost, ck.restore_latest))
    with pytest.raises(AssertionError, match="not the one it checkpointed"):
        smoke.phase_lm_train("cpu", str(tmp_path), models=LM_MODELS[:1],
                             reduced=True)


def test_lm_train_detects_a_loss_that_does_not_fall(smoke, tmp_path,
                                                    monkeypatch):
    """A step that leaves the params where they were."""
    from repro_torch.launch import train as tr
    real = tr.adamw_update

    def stuck(params, grads, opt, cfg):
        _, new_opt, met = real(params, grads, opt, cfg)
        return params, new_opt, met

    monkeypatch.setattr(tr, "adamw_update", stuck)
    monkeypatch.setattr(smoke, "write_zipf_shard",
                        functools.partial(_constant_shard, smoke))
    with pytest.raises(AssertionError):
        smoke.phase_lm_train("cpu", str(tmp_path), models=LM_MODELS[:1],
                             reduced=True)


def _constant_shard(smoke, path, vocab, n=200_000, seed=0):
    """One token repeated: every window is the same, so only a moving
    model can lower the loss."""
    from repro_torch.data import write_token_shard
    write_token_shard(path, np.full(n, 7), vocab)


def test_state_fingerprint_sees_one_bit(smoke):
    g = torch.Generator().manual_seed(0)
    tree = {"params": {"w": torch.randn(300, 7, generator=g),
                       "b": torch.randn(5, generator=g).bfloat16()},
            "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    a = smoke.state_fingerprint(tree, chunk=256)
    assert sorted(a) == ["opt/step", "params/b", "params/w"]
    same = smoke.state_fingerprint(
        {"params": {k: v.clone() for k, v in tree["params"].items()},
         "opt": {"step": tree["opt"]["step"].clone()}}, chunk=256)
    assert all(torch.equal(a[k], same[k]) for k in a)
    for key, leaf in (("params/w", tree["params"]["w"]),
                      ("params/b", tree["params"]["b"])):
        bits = leaf.view(torch.int32 if leaf.element_size() == 4
                         else torch.int16).reshape(-1)
        bits[-1] ^= 1                               # the lowest bit
        b = smoke.state_fingerprint(tree, chunk=256)
        assert not torch.equal(a[key], b[key]), key
        bits[-1] ^= 1


def test_moe_k2_shapes_name_every_combine(smoke, tmp_path):
    moe = {"models": {"qwen2-moe-a2.7b": {
        "d_model": 64, "combine_ids": {"prefill": (torch.arange(8), 4),
                                       "decode": (torch.arange(2), 1)}},
        "dbrx-132b": {"d_model": 32, "combine_ids": {
            "prefill": (torch.arange(6), 3), "decode": (torch.arange(2),
                                                       1)}}}}
    lmt = {"models": {"smollm-360m": {"d_model": 48},
                      "qwen2-moe-a2.7b": {"d_model": 64, "combine_ids": (
                          torch.arange(16), 8)}}}
    shapes = smoke.moe_k2_shapes(moe, lmt)
    assert {k: v[1:] for k, v in shapes.items()} == {
        "qwen2_moe_combine_prefill": (4, 64, False),
        "qwen2_moe_combine_decode": (1, 64, False),
        "dbrx_combine_prefill": (3, 32, False),
        "dbrx_combine_decode": (1, 32, False),
        "qwen2_moe_combine_train": (8, 64, True)}
    # K3's timed kinds are named apart from K2's labels (one launch
    # count dict holds both)
    assert not set(shapes) & set(smoke.MOE_K3_SHAPES)
