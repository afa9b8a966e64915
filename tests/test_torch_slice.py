"""The slice as a whole at small size: the load, serve, LogCSR and GCN
serving phases of ``chip_smoke.py`` run here with ``device="cpu"`` at
scale 10, so what the GPU run drives is what these tests ran.  Each phase
checks the loaded CSR and every query answer against the generated graph
bit for bit (tolerance ZERO), and the served logits against the plain
CPU path (tolerance ``GNN_TOL``; on the CPU the two are the same code, so
the error is 0), and raises on any difference."""

import contextlib
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


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


@pytest.fixture(scope="module")
def small(smoke, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("slice"))
    csr, path, _, _ = smoke.make_graph(10, workdir)
    return csr, path, workdir


def test_load_phase_on_cpu(smoke, small):
    csr, path, _ = small
    out = smoke.phase_load(csr, path, "cpu")
    assert out["edges"] == csr.n_edges and out["vertices"] == csr.n_vertices
    assert out["partitions"] > 1 and out["bytes_h2d"] > 0
    assert out["launches"] == 0          # a CPU tensor never launches
    assert out["b"] == 2 and out["max_partition_ids"] >= 1024


def test_serve_phase_on_cpu(smoke, small):
    csr, path, _ = small
    out = smoke.phase_serve(csr, path, "cpu", n_batches=4, batch=256)
    assert out["device_batches"] == out["batches"] >= 5
    assert out["bytes_h2d"] > 0 and out["ids_checked"] > 0
    assert out["auto_batches"] == 4 and out["launches"] == 0
    assert out["p50_s"] <= out["p99_s"]


def test_logcsr_phase_on_cpu(smoke, small):
    _, _, workdir = small
    out = smoke.phase_logcsr("cpu", 10, workdir, n_batches=2, batch=128)
    assert out["load"]["edges"] > 0 and out["serve"]["ids_checked"] > 0


def test_load_phase_detects_a_wrong_graph(smoke, small):
    csr, path, _ = small
    wrong = type(csr)(offsets=csr.offsets.copy(),
                      neighbors=csr.neighbors.copy())
    wrong.neighbors[7] ^= 1
    with pytest.raises(AssertionError, match="neighbors differ"):
        smoke.phase_load(wrong, path, "cpu")
    with pytest.raises(AssertionError):
        smoke.phase_serve(wrong, path, "cpu", n_batches=8, batch=1024,
                          n_async=0, n_auto=0)


def test_bound_and_library_yardsticks(smoke):
    ms, by = smoke.bound_ms(1 << 28, 3)
    assert by == "bytes"
    assert ms == pytest.approx((1 << 28) * 7 / 3.35e12 * 1e3)
    assert smoke.library_call(3) is None and smoke.library_call(2) is None
    p = torch.arange(16, dtype=torch.uint8)
    np.testing.assert_array_equal(
        smoke.library_call(4)(p).numpy(),
        smoke.compbin_decode_ref(p, 4).numpy())
    np.testing.assert_array_equal(
        smoke.library_call(1)(p).numpy(),
        smoke.compbin_decode_ref(p, 1).numpy())


def test_main_refuses_to_run_without_a_gpu(smoke, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal path is not "
                    "reachable")
    assert smoke.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_gnn_phase_on_cpu(smoke, small):
    _, _, workdir = small
    out = smoke.phase_gnn("cpu", workdir, scale=10, reduced=True,
                          n_requests=3, batch=64)
    assert out["arch"] == "gcn-cora-reduced" and out["vertices"] == 1024
    assert out["nodes_per_request"] == 64 * (1 + 5 + 25)
    assert out["edge_slots_per_request"] == 64 * (5 + 25)
    assert out["max_abs_err"] == 0.0
    assert out["k1_launches"] == out["k2_launches"] == 0
    assert out["device_batches"] > 0            # decode="auto" placed some
    assert len(out["latency_s"]) == 3 and out["p50_s"] <= out["p99_s"]
    assert {"sample", "gather", "features", "h2d",
            "compute"} <= set(out["tier_s_per_request"])
    assert out["edge_dst"].dtype == np.int32
    assert out["edge_dst"].size == out["edge_slots_per_request"]


def test_gnn_phase_detects_wrong_logits(smoke, small, monkeypatch):
    _, _, workdir = small
    plain = smoke.gnn_plain_logits

    def off_by_a_little(*args, **kwargs):
        for logits, dst, n in plain(*args, **kwargs):
            yield logits + 1e-3, dst, n

    monkeypatch.setattr(smoke, "gnn_plain_logits", off_by_a_little)
    with pytest.raises(AssertionError, match="served logits differ"):
        smoke.phase_gnn("cpu", workdir, scale=10, reduced=True,
                        n_requests=1, batch=16)


def test_segment_sum_bound(smoke):
    # every slot valid: the all-valid figure 358,166,528 B
    ms, by = smoke.k2_bound_ms(30720, 1433, 31744, 30720)
    assert by == "bytes"
    assert ms == pytest.approx(358_166_528 / 3.35e12 * 1e3)
    # dropped rows of messages need not be read
    assert smoke.k2_bytes(30720, 1433, 31744, 16436) == \
        358_166_528 - 4 * (30720 - 16436) * 1433
    assert smoke.k2_bound_ms(30720, 1, 31744, 0)[1] == "bytes"


def test_segment_sum_checks_on_cpu(smoke):
    out = smoke.phase_segment_sum_checks("cpu", n_seeds=64)
    # (6 sweep shapes x 2 id ranges + 9 layouts) x f32/bf16 x (atomic,
    # rows, the public path), then 3 empty shapes x 2 designs
    assert out["cases"] == (6 * 2 + len(smoke.K2_LAYOUTS)) * 2 * 3 + 6 \
        == 132
    det = out["determinism"]
    assert det["rows_equal_across_calls"] and det["rows_equal_cpu_plain"]
    assert (det["e"], det["n"], det["d"]) == (64 * 30, 64 * 31, 1433)


def test_served_tree_ids_have_the_served_layout(smoke):
    ids, n = smoke.served_tree_ids(1024)
    assert ids.dtype == np.int32 and (ids.size, n) == (30720, 31744)
    valid = ids[ids >= 0]
    assert np.all(np.diff(valid) >= 0)                 # ascending
    assert 0.45 < valid.size / ids.size < 0.6          # ~53 % valid
    assert valid.max() < 1024 + 5120                   # leaves get nothing
    runs = np.bincount(valid)
    assert runs.max() == 5                             # runs of the fanout


def _perturb_second_rows_call(smoke, monkeypatch):
    real, calls = smoke._segment_sum_design, []

    def fake(msgs, ids, n, design):
        out = real(msgs, ids, n, design)
        calls.append(design)
        if len(calls) == 2:                   # one ulp off, one element
            out[0, 0] = torch.nextafter(out[0, 0], torch.tensor(np.inf))
        return out
    monkeypatch.setattr(smoke, "_segment_sum_design", fake)


def test_k2_determinism_check_detects_a_changed_bit(smoke, monkeypatch):
    assert smoke.check_k2_determinism("cpu", n_seeds=32)[
        "rows_equal_across_calls"]
    _perturb_second_rows_call(smoke, monkeypatch)
    with pytest.raises(AssertionError, match="not bit-identical"):
        smoke.check_k2_determinism("cpu", n_seeds=32)


def _plain(msgs, ids, n):
    from repro_torch.kernels.segment_sum import segment_sum_ref
    return segment_sum_ref(msgs, ids, n)


def _wrapping_design(msgs, ids, n, design):
    """The fault the wide-id repair removed: ids narrowed to int32."""
    return _plain(msgs, ids.to(torch.int32), n)


def _dropping_design(msgs, ids, n, design):
    """One valid edge lost."""
    ids = ids.clone()
    valid = torch.nonzero((ids >= 0) & (ids < n))
    if valid.numel():
        ids[valid[-1, 0]] = -1
    return _plain(msgs, ids, n)


def _ulp_design(msgs, ids, n, design):
    """Sums one ulp off where the layout is exact."""
    out = _plain(msgs, ids, n)
    if out.numel():
        out[0, 0] = torch.nextafter(out[0, 0], torch.tensor(np.inf))
    return out


@pytest.mark.parametrize("fault,match", [
    (_wrapping_design, "atomic on wide"),
    (_dropping_design, "atomic on sweep E=64 D=16 N=4"),
    (_ulp_design, r"atomic on one_segment .*\(exact layout\)"),
])
def test_k2_layout_checks_detect_a_planted_fault(smoke, monkeypatch, fault,
                                                 match):
    monkeypatch.setattr(smoke, "_segment_sum_design", fault)
    with pytest.raises(AssertionError, match=match):
        smoke.phase_segment_sum_checks("cpu", n_seeds=32)


def test_k2_plan_check_detects_a_slower_pick(smoke):
    timed = {"layer0": {"design": "rows", "designs": {
        "atomic": {"ms": 0.24}, "rows": {"ms": 0.13}}}}
    smoke.check_k2_plan_picks_the_faster(timed)
    timed["layer0"]["design"] = "atomic"
    with pytest.raises(AssertionError, match="plan picks atomic at layer0"):
        smoke.check_k2_plan_picks_the_faster(timed)


def test_lm_phases_on_cpu(smoke):
    """The LM phases at the reduced smollm-360m config: on the CPU the
    K3 path and the plain path are one code, so the logits agree exactly
    and no kernel launches."""
    from repro_torch.configs import get_arch
    cfg = get_arch("smollm-360m").make_reduced()
    out = smoke.phase_lm_check("cpu", cfg, batch=2, prompt_len=16,
                               n_tokens=4, e2e_layers=1)
    assert out["max_abs_err"] == 0.0 and out["flips"] == []
    assert out["steps_compared"] == 8 and out["launches"] == 0
    assert out["shadow_calls"] == 2 * 4
    # one code on the CPU: the same f32 rounding against f64
    assert out["shadow_max_abs_err"] == out["shadow_plain_max_abs_err"] < 1e-3
    assert out["full_depth_k3_vs_plain"]["max_abs_err"] == 0.0
    assert out["full_depth_k3_vs_plain"]["tokens_equal"] == 1.0
    assert out["full_depth_dense_vs_chunked"]["steps_compared"] >= 2
    served = smoke.phase_lm_serve("cpu", cfg, batch=3, prompt_len=12,
                                  n_tokens=5)
    assert served["launches"] == 0 and served["tokens_per_s"] > 0
    assert served["prefill_flops"] > 0 and served["n_layers"] == 2


def test_lm_check_detects_wrong_logits(smoke, monkeypatch):
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    cfg = get_arch("smollm-360m").make_reduced()

    def off(q, k, v, cfg, *, causal, q_offset=0):
        return tf.attention_plain(q, k, v, cfg, causal=causal,
                                  q_offset=q_offset) + 0.05

    # the path under test is wrong; the plain yardstick is not: the
    # shadow check of each call catches it, and so does the end-to-end
    # check once the shadow is out of the way
    monkeypatch.setattr(tf, "attention", off)
    with pytest.raises(AssertionError, match="!= f64 attention"):
        smoke.phase_lm_check("cpu", cfg, batch=2, prompt_len=8, n_tokens=3)
    assert tf.attention is off           # restored
    monkeypatch.setattr(smoke, "shadow_attention",
                        lambda errs: _fill(errs, 2 * 3))
    with pytest.raises(AssertionError, match="logits differ"):
        smoke.phase_lm_check("cpu", cfg, batch=2, prompt_len=8, n_tokens=3)
    assert tf.attention is off


@contextlib.contextmanager
def _fill(errs, n):
    yield
    errs.extend([0.0] * n)


def test_flash_attention_bounds(smoke):
    # the served prefill: 41,943,040 B and 1.61e10 causal FLOP
    nbytes, flops = smoke.k3_work(8, 15, 5, 1024, 64, 1024, 0)
    assert nbytes == 41_943_040
    assert flops == 4 * 8 * 15 * 64 * (1024 * 1025 // 2)
    ms, by = smoke.k3_bound_ms(nbytes, flops)
    assert by == "operations" and ms == pytest.approx(flops / 989e12 * 1e3)
    # one decode step over 1087 live positions: the K/V read bounds it
    nbytes, flops = smoke.k3_work(8, 15, 5, 1, 64, 1087, 1086)
    assert nbytes == 2 * (2 * 8 * 15 * 64 + 2 * 8 * 5 * 1087 * 64)
    assert flops == 4 * 8 * 15 * 64 * 1087
    assert smoke.k3_bound_ms(nbytes, flops)[1] == "bytes"
    # rows that see no key cost nothing
    assert smoke.k3_work(1, 2, 2, 40, 64, 16, -24)[1] == \
        4 * 2 * 64 * sum(min(16, max(0, i - 23)) for i in range(40))


def test_lm_shadow_phase_on_cpu(smoke):
    """The served-dtype shadow phase at the reduced smollm-360m config in
    bf16: every call is held to f64 (on the CPU the plain path serves)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_arch("smollm-360m").make_reduced(),
                              dtype=torch.bfloat16)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    out = smoke.phase_lm_shadow("cpu", cfg, params, batch=2, prompt_len=12,
                                n_tokens=3)
    assert out["calls"] == cfg.n_layers * 3 and out["launches"] == 0
    assert out["max_abs_err"] == out["plain_max_abs_err"]


def _drop_last_key(q, k, v, cfg, *, causal, q_offset=0):
    """Attention that misses the last key each call should see."""
    from repro_torch.kernels.flash_attention import attention_bshd
    live = q_offset + q.shape[1]
    return attention_bshd(q, k[:, :live], v[:, :live], causal=causal,
                          offset=q_offset, kv_len=live - 1)


def _zeros(q, k, v, cfg, *, causal, q_offset=0):
    return torch.zeros_like(q)


@pytest.mark.parametrize("fault", [_zeros, _drop_last_key])
def test_lm_shadow_phase_detects_a_planted_fault(smoke, monkeypatch, fault):
    """The bf16 shadow phase with the served attention broken.  V is
    scaled up to the ~60 the full-width served model reaches, where a
    relative tolerance scaled with max|v| would exceed 1 and let any
    output of the right size through."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_arch("smollm-360m").make_reduced(),
                              dtype=torch.bfloat16)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    params["layers"]["wv"] = params["layers"]["wv"] * 4
    out = smoke.phase_lm_shadow("cpu", cfg, params, batch=2, prompt_len=12,
                                n_tokens=3)
    assert out["atol_max"] > 1.0            # rtol stays 2e-2 all the same
    monkeypatch.setattr(tf, "attention", fault)
    with pytest.raises(AssertionError, match="!= f64 attention"):
        smoke.phase_lm_shadow("cpu", cfg, params, batch=2, prompt_len=12,
                              n_tokens=3)
    assert tf.attention is fault            # restored


def test_shadow_attention_tolerance_is_relative_plus_scaled_floor(
        smoke, monkeypatch):
    """One bf16 call with max|v| = 60, so atol is 2e-2 x 60 = 1.2 while
    rtol stays 2e-2: the plain path passes; an output 10 % off the truth
    and zeros both fail (both would pass a relative tolerance of 1.2)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_arch("smollm-360m").make_reduced(),
                              dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(2, 6, cfg.n_heads, cfg.d_head, generator=gen) * 0.3
    k = torch.randn(2, 6, cfg.n_kv_heads, cfg.d_head, generator=gen) * 0.3
    v = torch.randn(2, 6, cfg.n_kv_heads, cfg.d_head, generator=gen)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v * (60 / v.abs().max())))
    plain = tf.attention_plain
    for served, ok in ((plain, True),
                       (lambda *a, **kw: plain(*a, **kw) * 1.1, False),
                       (_zeros, False)):
        monkeypatch.setattr(tf, "attention", served)
        errs: list = []
        with smoke.shadow_attention(errs):
            if ok:
                tf.attention(q, k, v, cfg, causal=True)
                assert errs[0][2] == pytest.approx(2e-2 * 60)
            else:
                with pytest.raises(AssertionError, match="rtol 0.02,"):
                    tf.attention(q, k, v, cfg, causal=True)


def test_flash_attention_f32_bounds_and_shapes(smoke):
    # f32 moves 4 bytes an element and runs at the CUDA cores' rate
    nbytes, flops = smoke.k3_work(2, 15, 5, 512, 64, 512, 0, elem=4)
    assert nbytes == 2 * smoke.k3_work(2, 15, 5, 512, 64, 512, 0)[0]
    ms, by = smoke.k3_bound_ms(nbytes, flops, smoke.FP32_OPS_PER_S)
    assert by == "operations" and ms == pytest.approx(flops / 67e12 * 1e3)
    # one timed shape per design, each with the design it is named for
    from repro_torch.kernels.flash_attention import plan
    want = {"prefill": "tc_prefill", "decode": "split_decode",
            "prefill_f32": "fma", "decode_f32": "split_decode"}
    for kind, sh in smoke.K3_SHAPES.items():
        sq, kv = (sh["s"], sh["s"]) if "s" in sh else (1, sh["live"])
        assert plan(sh["dtype"], 3 * sq, kv, 64, 5 * sh["b"])[0] == want[kind]


def test_k3_build_report_names_the_fma_designs(smoke, monkeypatch):
    """k3_fma serves f32 prefill (SPLIT false) and f32 split decode
    (SPLIT true); the report tells the two apart."""
    from repro_torch.kernels.flash_attention import kernel
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_12cc6k3_fmaILi64ELb0EEEvNS_6ParamsEPf' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_12cc6k3_fmaILi128ELb1EEEvNS_6ParamsEPf' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers
"""
    monkeypatch.setattr(kernel, "smem_bytes",
                        lambda design, dh, bf16: 1000 * design + dh + bf16)
    rows = smoke.k3_instantiations(log, "/nonexistent/nvcc")
    assert [(r["registers"], r["smem_bytes"]) for r in rows] == \
        [(64, 1064), (72, 2128)]


def test_k3_build_report_parses_ptxas(smoke, monkeypatch):
    from repro_torch.kernels.flash_attention import kernel
    log = """ptxas info    : Compiling entry function '_ZN1_2tc5k3_tcILi64ELi2ELb0EEEvNS_6ParamsEPf' for 'sm_90a'
ptxas info    : Function properties for x
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 118 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN1_2sd16k3_split_combineIfLi128EEEvNS_6ParamsEPKfi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""
    monkeypatch.setattr(kernel, "smem_bytes",
                        lambda design, dh, bf16: 1000 * design + dh + bf16)
    rows = smoke.k3_instantiations(log, "/nonexistent/nvcc")
    assert [(r["registers"], r["spill_stores"], r["spill_loads"],
             r["smem_bytes"]) for r in rows] == [(118, 8, 4, 65), (32, 0, 0, 0)]
