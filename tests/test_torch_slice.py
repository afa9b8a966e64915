"""The slice as a whole at small size: the load, serve, LogCSR and GCN
serving phases of ``chip_smoke.py`` run here with ``device="cpu"`` at
scale 10, so what the GPU run drives is what these tests ran.  Each phase
checks the loaded CSR and every query answer against the generated graph
bit for bit (tolerance ZERO), and the served logits against the plain
CPU path (tolerance ``GNN_TOL``; on the CPU the two are the same code, so
the error is 0), and raises on any difference."""

from _torch_env import load_chip_smoke  # first: one torch thread
import contextlib
import json

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def smoke():
    return load_chip_smoke()


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


def test_segment_sum_backward_bound_reads_each_grad_row_once(smoke):
    # the full-graph shape: grad f32[262144, 16] by 3,939,466 int32 ids
    # that name every row; grad_out read once, not once an edge
    ms, by = smoke.k2_grad_bound_ms(3_939_466, 16, 262_144, 4)
    assert by == "bytes"
    assert ms == pytest.approx(284_660_904 / 3.35e12 * 1e3)
    # int64 ids read 8 bytes each; no distinct row read, only writes
    assert smoke.k2_grad_bound_ms(10, 16, 0, 8)[0] == pytest.approx(
        (4 * 10 * 16 + 10 * 8) / 3.35e12 * 1e3)


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


# ---------------------------------------------------------------------------
# [train] and [compile], and K2's backward checks, with planted faults
# ---------------------------------------------------------------------------

TRAIN_KW = dict(scale=10, edge_factor=8, parity_scale=9, reduced=True,
                sampled_seeds=256, sampled_steps=4)


def test_train_phase_on_cpu(smoke, tmp_path):
    out = smoke.phase_train("cpu", str(tmp_path), **TRAIN_KW)
    assert out["vertices"] == 1024 and out["hosts"] == 2
    assert len(out["losses"]) == 10 and out["losses"][-1] < out["losses"][0]
    books = out["stats_hosts_vs_one"]
    for k in smoke.STREAM_DATA_COUNTERS:
        assert books[k][0] == books[k][1]
    assert books["host_decode_bytes"] == (0, 0)
    assert out["restart"]["steps_replayed"] == 1
    rs = out["restart"]                  # the CPU is deterministic
    assert rs["loss_rel_err"] == 0.0
    assert all(d["max_abs"] == 0.0 for d in rs["drift"].values())
    assert all(d["max_abs"] == 0.0 for d in rs["noise_floor"].values())
    assert out["parity"]["loss_rel_err"] == 0.0
    # a CPU tensor never launches a kernel
    assert out["k1_launches"] == out["k2_launches"] == \
        out["k2_grad_launches"] == 0 and out["k2_per_step"] == [0, 0]
    assert out["sampled"]["device_batches"] > 0
    assert out["full_graph_ids"].numel() == out["edges"]


def test_k2_backward_checks_on_cpu(smoke):
    out = smoke.phase_segment_sum_checks("cpu", n_seeds=32)
    # 21 cases x f32/bf16, 3 checks each (the public entry, autograd, an
    # expanded grad_out) but for E = 0, where the CPU's plain version
    # returns zeros that autograd cannot differentiate; then one a vector
    # width D allows: the sweep's D 16/200/128/8/24 take 3, D 1 one, the
    # layouts' D 1433 and 67 one, many_segments' D 24 three; then
    # K2_GRAD_WIDTHS aligned (D 16 three widths, D 2 two) and one float
    # off (one each), 3 + widths each
    cases = (6 * 2 + len(smoke.K2_LAYOUTS)) * 2 * 3 - 2
    widths = ((3 + 3 + 3 + 1 + 3 + 3) * 2 + 8 * 1 + 3) * 2
    extra = 2 * 3 * len(smoke.K2_GRAD_WIDTHS) + (1 + 2 + 1 + 1 + 3 + 1 + 1) \
        + len(smoke.K2_GRAD_WIDTHS)
    assert out["backward_checks"] == cases + widths + extra == 269


def _flip_one_grad(grad_out, ids, n):
    from repro_torch.kernels.segment_sum import segment_sum_grad_ref
    out = segment_sum_grad_ref(grad_out, ids, n)
    if out.numel():
        out.view(-1)[out.numel() // 2] += 1.0
    return out


def _wrap_wide_ids(grad_out, ids, n):
    """The wide-id fault on the backward: ids narrowed to int32, so an
    id of 2^32 gathers row 0 instead of giving a zero row."""
    from repro_torch.kernels.segment_sum import segment_sum_grad_ref
    return segment_sum_grad_ref(grad_out, ids.to(torch.int32), n)


@pytest.mark.parametrize("fault,match", [
    (_flip_one_grad, r"segment_sum backward on sweep E=64 D=16 N=4"),
    (_wrap_wide_ids, r"segment_sum backward on wide"),
])
def test_k2_backward_check_detects_a_planted_fault(smoke, monkeypatch,
                                                   fault, match):
    monkeypatch.setattr(smoke, "segment_sum_backward", fault)
    with pytest.raises(AssertionError, match=match):
        smoke.phase_segment_sum_checks("cpu", n_seeds=32)


def test_k2_backward_width_check_detects_a_planted_fault(smoke, monkeypatch):
    """A fault in one vector width's arm alone (VEC 4: one element off)
    is caught by the check that forces each width."""
    from repro_torch.kernels.segment_sum import segment_sum_grad_ref

    def fault(grad_out, ids, n, vec):
        out = segment_sum_grad_ref(grad_out, ids, n)
        if vec == 4 and out.numel():
            out.view(-1)[-1] -= 1.0
        return out

    monkeypatch.setattr(smoke, "_segment_sum_backward_vec", fault)
    with pytest.raises(AssertionError,
                       match=r"segment_sum backward at VEC 4 on sweep E=64"):
        smoke.phase_segment_sum_checks("cpu", n_seeds=32)


def _event(key, count, device_us, cuda=True):
    from types import SimpleNamespace
    kind = torch.autograd.DeviceType.CUDA if cuda else \
        torch.autograd.DeviceType.CPU
    return SimpleNamespace(key=key, count=count, device_type=kind,
                           device_time_total=device_us)


def test_launches_per_call_divides_a_window_of_calls(smoke):
    """Eight calls of K2's atomic design in one trace: two template
    instantiations of the kernel and the zero-fill; per call, one K2
    launch, two in all, and each kernel's device time a call by name."""
    events = [_event("void k2_atomic<int>(float const*, ...)", 6, 600.0),
              _event("void k2_atomic<long>(float const*, ...)", 2, 200.0),
              _event("void at::native::vectorized_elementwise_kernel", 8,
                     80.0),
              _event("aten::zeros", 8, 0.0, cuda=False),
              _event("ProfilerStep*", 1, 620.0)]
    assert smoke.launches_per_call(events, "k2_", 8) == (
        1, 2, {"k2_atomic": 0.1})


@pytest.mark.parametrize("events,match", [
    ([_event("k2_grad<int, 4>", 7, 10.0)], "7 k2_ kernels"),
    ([_event("k2_grad<int, 4>", 8, 10.0), _event("fill", 3, 1.0)],
     "11 in all"),
    ([_event("fill", 8, 1.0)], "no k2_ kernel"),
])
def test_launches_per_call_refuses_a_partial_trace(smoke, events, match):
    with pytest.raises(AssertionError, match=match):
        smoke.launches_per_call(events, "k2_", 8)


def test_cuda_launches_drops_the_warm_up_and_retries(smoke, monkeypatch):
    """``cuda_launches`` against a stubbed profiler: the warm-up call sits
    in the schedule's warm-up step, so only the ``TRACE_CALLS`` calls
    after it are counted; a window with no device event is traced again,
    and after ``attempts`` such windows the result is None (not
    measured)."""
    import torch.profiler as tp

    traces = []

    class Profile:
        def __init__(self, activities, schedule):
            self.calls, self.step_no, self.schedule = 0, 0, schedule
            self.sees_card = len(traces) >= 1   # the first window: none

        def __enter__(self):
            traces.append(self)
            return self

        def __exit__(self, *exc):
            return False

        def step(self):
            self.step_no += 1

        def record(self):
            if self.schedule(self.step_no) == \
                    tp.ProfilerAction.RECORD_AND_SAVE:
                self.calls += 1

        def key_averages(self):
            if not self.sees_card:
                return [_event("aten::empty", self.calls, 0.0, cuda=False)]
            return [_event("k2_grad<int, 4>", self.calls, 5.0 * self.calls),
                    _event("memset", 2 * self.calls, 1.0),
                    _event("ProfilerStep*", 1, 400.0)]

    monkeypatch.setattr(tp, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    assert smoke.cuda_launches(lambda: traces[-1].record(), "k2_") == (
        1, 3, {"k2_grad": 0.005})
    assert len(traces) == 2 and traces[-1].calls == 8
    traces.clear()
    monkeypatch.setattr(Profile, "key_averages",
                        lambda self: [_event("aten::empty", 1, 0.0, False)])
    assert smoke.cuda_launches(lambda: traces[-1].record(), "k2_",
                               attempts=3) is None
    assert len(traces) == 3


def test_cuda_launches_retraces_a_window_that_lost_a_call(smoke,
                                                          monkeypatch):
    """A window that lost one call's kernels (7 of 8) is traced again;
    if every window loses one, the count is refused, not rounded."""
    import torch.profiler as tp

    traces = []

    class Profile:
        def __init__(self, activities, schedule):
            traces.append(self)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def step(self):
            pass

        def key_averages(self):
            calls = 8 if len(traces) >= lost_windows + 1 else 7
            return [_event("k2_grad<int, 4>", calls, 2.0 * calls)]

    monkeypatch.setattr(tp, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    lost_windows = 2
    assert smoke.cuda_launches(lambda: None, "k2_") == (
        1, 1, {"k2_grad": 0.002})
    assert len(traces) == 3
    traces.clear()
    lost_windows = 4
    with pytest.raises(AssertionError, match="7 k2_ kernels"):
        smoke.cuda_launches(lambda: None, "k2_", attempts=4)
    assert len(traces) == 4


def _lost_restore(real, ckpt_dir, tree_like, **kw):
    """The checkpoint lost: the state handed in comes back."""
    step, _ = real(ckpt_dir, tree_like, **kw)
    return step, tree_like


def _lost_params(real, ckpt_dir, tree_like, **kw):
    """Only the optimizer state restored; the params stay a step ahead."""
    step, got = real(ckpt_dir, tree_like, **kw)
    return step, {**got, "params": tree_like["params"]}


@pytest.mark.parametrize("fault", [_lost_restore, _lost_params])
def test_train_restart_check_detects_a_lost_restore(smoke, monkeypatch,
                                                    tmp_path, fault):
    """A restore that loses the checkpoint leaves the run an AdamW step
    ahead: the check must see it."""
    import functools

    import repro_torch.checkpoint as ck
    monkeypatch.setattr(ck, "restore_latest",
                        functools.partial(fault, ck.restore_latest))
    with pytest.raises(AssertionError, match="not the one it checkpointed"):
        smoke.phase_train("cpu", str(tmp_path), **TRAIN_KW)


def _gcn_state(seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w0": torch.randn(6, 3, generator=g) * scale,
                       "b0": torch.randn(3, generator=g) * scale}}


def test_restart_check_catches_a_run_a_step_off(smoke):
    """The parts of ``check_restart`` the CPU run cannot reach with a
    planted restore fault: a loss trajectory one step off, and final
    params off by more than the share of the distance moved."""
    start = _gcn_state(0)["params"]
    clean = {"params": {k: v + 1.0 for k, v in start.items()}}
    near = {"params": {k: v + 1.0 + 1e-4 for k, v in start.items()}}
    far = {"params": {k: v + 1.1 for k, v in start.items()}}
    st = _gcn_state(3)
    losses = [1.90, 1.89, 1.88]
    out = smoke.check_restart(st, st, losses, losses, near, clean, start)
    assert out["loss_rel_err"] == 0.0
    assert all(d["share"] < 1e-3 for d in out["drift"].values())
    with pytest.raises(AssertionError, match="losses after the restore"):
        smoke.check_restart(st, st, losses[1:] + [1.87], losses, near,
                            clean, start)
    with pytest.raises(AssertionError, match="restored param w0"):
        smoke.check_restart(st, st, losses, losses, far, clean, start)
    with pytest.raises(AssertionError, match="not the one it checkpointed"):
        smoke.check_restart(st, _gcn_state(4), losses, losses, near, clean,
                            start)


def test_train_parity_check_detects_a_dropped_edge(smoke, monkeypatch,
                                                   tmp_path):
    """The kernel path losing one edge (the plain path keeps it) must
    fail the first-step comparison."""
    from repro_torch.kernels.segment_sum import segment_sum_ref
    from repro_torch.models.gnn import layers

    def dropping(msgs, ids, n):
        ids = ids.clone()
        ids[-1] = -1
        return segment_sum_ref(msgs, ids, n)

    monkeypatch.setattr(layers, "segment_sum", dropping)
    with pytest.raises(AssertionError, match="first-step"):
        smoke.phase_train("cpu", str(tmp_path), **TRAIN_KW)


def test_compile_phase_on_cpu(smoke, small):
    csr, path, workdir = small
    out = smoke.phase_compile(csr, path, "cpu", workdir, n_batches=4,
                              batch=256)
    assert out["strategy"] == "bfs" and out["out_bytes"] > 0
    assert out["ids_checked"] > 0 and out["launches"] == 0
    assert out["query_batches"] == 4
    assert 0.0 <= out["pgfuse_hit_rate"] <= 1.0 and out["blocks_touched"] > 0


def test_compile_check_detects_a_wrong_mapped_back_answer(smoke, small,
                                                          monkeypatch):
    from repro_torch.graph import reorder
    csr, path, workdir = small
    real = reorder.read_sidecar

    def swapped(p):
        perm = real(p).copy()
        hub = int(np.argmax(np.diff(csr.offsets)))
        j = int(np.flatnonzero(perm == hub)[0])
        k = (j + 1) % perm.size
        perm[[j, k]] = perm[[k, j]]
        return perm

    monkeypatch.setattr(reorder, "read_sidecar", swapped)
    with pytest.raises(AssertionError, match="differ"):
        smoke.phase_compile(csr, path, "cpu", workdir, n_batches=2,
                            batch=256)


# ---------------------------------------------------------------------------
# [gnn2]: PNA served and trained, MeshGraphNet and DimeNet trained, with
# planted faults each of its checks must catch
# ---------------------------------------------------------------------------

GNN2_KW = dict(scale=10, edge_factor=8, parity_scale=9, mgn_mesh=12,
               mgn_parity_mesh=10, dimenet_scale=9, dimenet_parity_scale=8,
               n_requests=2, batch=64, reduced=True)


def _pna_cfg():
    from repro_torch.configs import get_arch
    return get_arch("pna").make_reduced()


def test_gnn2_phase_on_cpu(smoke, tmp_path):
    out = smoke.phase_gnn2("cpu", str(tmp_path), **GNN2_KW)
    srv, pt = out["serve"], out["pna_train"]
    assert srv["arch"] == "pna-reduced" and srv["max_abs_err"] == 0.0
    assert srv["nodes_per_request"] == 64 * (1 + 5 + 25)
    pt_losses = pt["losses"]
    assert len(pt_losses) == 10 and pt_losses[-1] < pt_losses[0]
    assert pt["vertices"] == 1024 and pt["hosts"] == 2
    par = pt["parity"]                  # the CPU is deterministic
    assert par["loss_rel_err"] == 0.0
    assert par["grad_max_abs_err_vs_f64"] == par["plain_max_abs_err_vs_f64"]
    assert out["meshgraphnet"]["graph"] == "bipartite_mesh(12, 12)"
    assert out["dimenet"]["graph"] == "rmat(9, 16)"
    for arch, n in (("meshgraphnet", 144), ("dimenet", 512)):
        r = out[arch]
        assert len(r["cli_losses"]) == 10 and r["vertices"] == n
        par = r["parity"]
        assert par["loss_rel_err"] == 0.0
        assert par["grad_max_abs_err_vs_f64"] == \
            par["plain_max_abs_err_vs_f64"]
    # a CPU tensor never launches a kernel
    assert out["k1_launches"] == out["k2_launches"] == \
        out["k2_grad_launches"] == 0
    smoke.log_gnn2(out)                 # the report formats
    shapes = smoke.gnn2_k2_shapes(out)
    assert {k: (int(v[0].numel()), v[1], v[2], v[3])
            for k, v in shapes.items()} == {
        "pna_served": (64 * 30, 64 * 31, 12, False),
        "pna_full_graph": (pt["edges"], 1024, 12, True),
        "meshgraphnet": (out["meshgraphnet"]["edges"], 144, 16, True),
        "dimenet_triplets": (2 * out["dimenet"]["edges"],
                             out["dimenet"]["edges"], 4, True),
        "dimenet_readout": (512, 1, 1, True)}
    checks = smoke.check_k2_shapes(shapes)
    assert {k: v["checks"] for k, v in checks.items()} == {
        "pna_served": 3, "pna_full_graph": 4, "meshgraphnet": 4,
        "dimenet_triplets": 4, "dimenet_readout": 4}


def test_kernel_requests_count_what_a_step_asks(smoke, monkeypatch):
    """A toy step's requests, counted on CPU tensors (the device check
    made true): two segment sums with work, one on messages that need a
    gradient, one sum with none, and a gather of a tensor that needs a
    gradient through ``_Gather``, whose backward makes a sum of its own
    that counts as the gather's: K2's forward three times, its backward
    once.  The wrapped gather keeps the launch counter ``_Gather``'s
    backward adds to by the module's name."""
    from repro_torch.models.gnn import layers

    real, before = layers.gather, layers.gather.grad_launches
    with smoke.kernel_requests():       # as ``_Gather``'s backward counts
        layers.gather.grad_launches += 1
    assert real.grad_launches == before + 1
    real.grad_launches = before
    monkeypatch.setattr(smoke, "_on_card", lambda t: True)
    monkeypatch.setattr(layers, "gather", layers._Gather.apply)
    ids = torch.tensor([0, 2, 2, -1])
    x = torch.randn(3, 4, requires_grad=True)
    m = torch.randn(4, 4, requires_grad=True)
    with smoke.kernel_requests() as asked:
        msgs = m * layers.gather(x, ids)
        deg = layers.segment_sum(torch.ones(4, 1), ids, 3)
        none = layers.segment_sum(torch.ones(0, 4), ids[:0], 3)
        loss = (layers.segment_sum(msgs, ids, 3) / deg.clamp(min=1)).sum()
        loss.backward()
    assert asked == smoke.KernelRequests(sums=2, grad_sums=1, grad_gathers=1)
    assert asked.launches() == {"k2": 3, "k2_grad": 1}
    assert not none.any() and x.grad is not None and m.grad is not None


@pytest.mark.parametrize("edges", [6, 0])
def test_kernel_requests_count_a_fused_sum_as_one_sum(smoke, monkeypatch,
                                                      edges):
    """The fused gather, scale and sum at the seam the models call
    (``layers.gather_scale_sum``), counted on CPU tensors with the device
    check made true: one forward request with work, none without; under
    ``plain_segment_sum`` the same seam runs the unfused chain on the
    plain segment sum it was given."""
    from repro_torch.models.gnn import layers

    monkeypatch.setattr(smoke, "_on_card", lambda t: True)
    x, w = torch.randn(4, 3), torch.randn(edges)
    src = torch.arange(edges) % 4
    with smoke.kernel_requests() as asked:
        got = layers.gather_scale_sum(x, src, w, src, 4)
    assert asked == smoke.KernelRequests(sums=int(edges > 0))
    assert asked.launches() == {"k2": int(edges > 0), "k2_grad": 0}
    seen = []

    def recording(m, ids, n):
        seen.append(tuple(m.shape))
        return smoke.segment_sum_ref(m, ids, n)

    with smoke.plain_segment_sum(recording):
        plain = layers.gather_scale_sum(x, src, w, src, 4)
    assert seen == [(edges, 3)] and torch.equal(plain, got)


def test_fresh_launch_counter_loads_chip_smoke_in_a_new_process(smoke):
    """The new process :func:`fresh_k2_launches` starts loads this file as
    its script does, up to the first launch: the dataclasses in it need
    the module registered under its name."""
    import subprocess
    import sys

    head = smoke._FRESH_K2_LAUNCHES.split("out = {}")[0]
    done = subprocess.run(
        [sys.executable, "-c", head + "print(cs.KernelRequests(sums=2))",
         smoke.__file__], capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == \
        "KernelRequests(sums=2, grad_sums=0, grad_gathers=0)"


@pytest.mark.parametrize("fault", ["drop_last_edge", "stray_count"])
def test_fused_check_detects_a_planted_fault(smoke, monkeypatch, fault):
    """``check_gather_scale_sum`` (the fused kernel held to its plain
    version in chunks at the GCN cell's shape) fails on a fused op that
    loses an edge, and on one whose launch count moves where no kernel
    ran."""
    real = smoke.gather_scale_sum

    def faulty(x, src, w, dst, n):
        if fault == "drop_last_edge":
            dst = dst.clone()
            dst[-1] = -1
        else:
            smoke.segment_sum.gather_launches += 1
        return real(x, src, w, dst, n)

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-4, 5, (30, 100)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-2, 3, 500).astype(np.float32))
    src = torch.from_numpy(rng.integers(-1, 33, 500).astype(np.int32))
    dst = torch.from_numpy(rng.integers(-1, 33, 500).astype(np.int32))
    want, err = smoke.check_gather_scale_sum(x, src, w, dst, 30)  # sound
    assert err == 0.0 and want.shape == (30, 100)
    monkeypatch.setattr(smoke, "gather_scale_sum", faulty)
    with pytest.raises(AssertionError, match="gather_scale_sum"):
        smoke.check_gather_scale_sum(x, src, w, dst, 30)


@pytest.mark.parametrize("chunk", [1, 7, 64, 500, 10_000])
def test_plain_fused_version_in_chunks_is_one_call(smoke, chunk):
    """The plain version the fused kernel is held to at the cell's size,
    summed over chunks of edges, equals one call of
    ``gather_scale_sum_ref`` on small integers, at every chunk size
    (one edge, a ragged last chunk, a chunk past E)."""
    from repro_torch.kernels.segment_sum import gather_scale_sum_ref

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-4, 5, (30, 6)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-2, 3, 500).astype(np.float32))
    src = torch.from_numpy(rng.integers(-1, 33, 500).astype(np.int32))
    dst = torch.from_numpy(rng.integers(-1, 33, 500).astype(np.int32))
    want = gather_scale_sum_ref(x, src, w, dst, 30)
    got = smoke.plain_gather_scale_sum(x, src, w, dst, 30, chunk=chunk)
    assert want.abs().sum() > 0 and torch.equal(got, want)


def test_fused_timing_reads_the_cells_configuration(smoke):
    """The fused kernel's timing takes its width, edge law and node count
    from the GCN cell's own configuration file, and its own-bytes bound
    counts x, the three edge streams and the sums once each."""
    with open(smoke.GCN_CELL_CONFIG) as f:
        cfg = json.load(f)
    assert cfg["name"] == "gcn-cora.ogb-products"
    assert (cfg["d_in"], cfg["n_nodes"]) == (100, smoke.OGB_REAL[1])
    assert 2 * cfg["undirected_edges"] <= smoke.OGB_E
    assert {"scale", "seed"} <= cfg["edges"].keys()
    assert smoke.fused_bytes(10, 3, 7, 5) == 4 * 7 * 3 + 12 * 10 + 4 * 5 * 3
    assert smoke.fused_bytes(smoke.OGB_E, 100, smoke.OGB_N, smoke.OGB_N) < \
        smoke.k2_bytes(smoke.OGB_E, 100, smoke.OGB_N, smoke.OGB_REAL[0])


@pytest.mark.parametrize("phase", ["gnn", "train"])
def test_a_launch_short_of_the_requests_fails_a_phase(smoke, small, tmp_path,
                                                      monkeypatch, phase):
    """The first segment sum counted as asked of the card (the device
    check true once) where no kernel launched: the served requests' or
    the first training step's K2 launches one short of their requests
    must fail the phase."""
    asks = iter([True])
    monkeypatch.setattr(smoke, "_on_card", lambda t: next(asks, False))
    with pytest.raises(AssertionError, match="K2 launches"):
        if phase == "gnn":
            smoke.phase_gnn("cpu", small[2], scale=10, reduced=True,
                            n_requests=1, batch=16)
        else:
            smoke.phase_train("cpu", str(tmp_path), **TRAIN_KW)


def test_gnn2_pna_serving_detects_wrong_logits(smoke, tmp_path, monkeypatch):
    plain = smoke.gnn_plain_logits

    def off_by_a_little(*args, **kwargs):
        for logits, dst, n in plain(*args, **kwargs):
            yield logits + 1e-3, dst, n

    monkeypatch.setattr(smoke, "gnn_plain_logits", off_by_a_little)
    with pytest.raises(AssertionError, match="served logits differ"):
        smoke.phase_gnn2("cpu", str(tmp_path), **GNN2_KW)


def test_gnn2_pna_training_detects_a_loss_that_does_not_fall(
        smoke, tmp_path, monkeypatch):
    """A step that leaves the params where they were."""
    from repro_torch.launch import train as tr
    real = tr.adamw_update

    def stuck(params, grads, opt, cfg):
        _, new_opt, met = real(params, grads, opt, cfg)
        return params, new_opt, met

    monkeypatch.setattr(tr, "adamw_update", stuck)
    with pytest.raises(AssertionError, match="loss did not fall"):
        smoke.gnn2_pna_train("cpu", str(tmp_path), _pna_cfg(), scale=10,
                             edge_factor=8, hosts=2, steps=10,
                             parity_scale=9)


def _dropping_sum(msgs, ids, n):
    """The kernel path losing its last edge (the plain path keeps it)."""
    from repro_torch.kernels.segment_sum import segment_sum_ref
    ids = ids.clone()
    ids[-1] = -1
    return segment_sum_ref(msgs, ids, n)


def test_gnn2_pna_parity_detects_a_dropped_edge(smoke, tmp_path,
                                                monkeypatch):
    from repro_torch.models.gnn import layers
    monkeypatch.setattr(layers, "segment_sum", _dropping_sum)
    with pytest.raises(AssertionError, match="first-step"):
        smoke.gnn2_pna_train("cpu", str(tmp_path), _pna_cfg(), scale=9,
                             edge_factor=8, hosts=2, steps=2,
                             parity_scale=9)


def test_exact_close_holds_grads_to_the_float64_path(smoke):
    """The scale is the plain path's worst distance over all parameters
    relative to each one's max|g|: a parameter whose own plain draw lay
    close still gets the pooled scale."""
    exact = {"a": torch.tensor([1.0, -2.0, 0.0], dtype=torch.float64),
             "b": torch.tensor([0.5, 0.25], dtype=torch.float64),
             "empty": torch.zeros(0, dtype=torch.float64)}
    plain = {"a": exact["a"] + torch.tensor([4e-6, 0.0, 0.0]),
             "b": exact["b"].clone(), "empty": exact["empty"]}
    scale = smoke.relative_distance(plain, exact)
    assert scale == pytest.approx(2e-6)
    near = exact["b"] + torch.tensor([2e-6, 0.0])     # 4e-6 of max|g|
    assert smoke.exact_close(near.float(), exact["b"], scale, "b") < 3e-6
    far = exact["b"] + torch.tensor([0.0, 5e-6])
    with pytest.raises(AssertionError, match="b: max abs err .* from "
                       "float64 beyond"):
        smoke.exact_close(far.float(), exact["b"], scale, "b")
    assert smoke.exact_close(plain["empty"], exact["empty"], scale, "e") == 0


@pytest.mark.parametrize("arch", ["meshgraphnet", "dimenet"])
def test_gnn2_full_batch_parity_detects_a_dropped_edge(smoke, tmp_path,
                                                       monkeypatch, arch):
    from repro_torch.models.gnn import layers
    monkeypatch.setattr(layers, "segment_sum", _dropping_sum)
    with pytest.raises(AssertionError, match="first-step"):
        smoke.gnn2_trained(arch, "cpu", str(tmp_path), size=8,
                           parity_size=8, steps=2, reduced=True)


def _gnn2_shapes(smoke):
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(-1, 40, 300).astype(np.int32))
    return {"a": (ids, 40, 75, True),
            "one_segment": (torch.zeros(50, dtype=torch.int32), 1, 1, True)}


@pytest.mark.parametrize("fault,match", [
    (_dropping_design, "segment_sum atomic at a != plain"),
    (_ulp_design, "segment_sum atomic at a != plain")])
def test_k2_shape_checks_detect_a_planted_fault(smoke, monkeypatch, fault,
                                                match):
    monkeypatch.setattr(smoke, "_segment_sum_design", fault)
    with pytest.raises(AssertionError, match=match):
        smoke.check_k2_shapes(_gnn2_shapes(smoke))


def test_k2_shape_checks_detect_a_wrong_backward(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "segment_sum_backward", _flip_one_grad)
    with pytest.raises(AssertionError, match="backward at a != plain"):
        smoke.check_k2_shapes(_gnn2_shapes(smoke))


@pytest.mark.parametrize("arch", ["meshgraphnet", "dimenet"])
def test_gnn2_training_detects_a_non_finite_loss(smoke, tmp_path,
                                                 monkeypatch, arch):
    """A loss that turns NaN in the CLI's run must fail the phase."""
    from repro_torch.launch.steps import _GNN_MODULES
    mod = _GNN_MODULES[arch]
    real = mod.loss_fn
    monkeypatch.setattr(mod, "loss_fn",
                        lambda p, b, c: real(p, b, c) * float("nan"))
    with pytest.raises(AssertionError, match="nan"):
        smoke.gnn2_trained(arch, "cpu", str(tmp_path), size=8,
                           parity_size=8, steps=2, reduced=True)
