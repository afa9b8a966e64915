"""``chip_smoke.py``'s ``[cells]`` phase on the CPU at a reduced cell
list, so what the GPU run drives is what these tests ran, and a fault
planted in each of its checks makes it raise.

On the CPU no kernel launches, so every launch count is 0, and the
kernel path and the plain path are one code.  The cell list: gcn-cora
and PNA on ``molecule`` (with their first-step parity), gcn-cora on
``full_graph_sm`` under ``edges_compbin`` (the packed ids, and its first
step held to the plain path fed the int64 ids), a prefill of
the reduced smollm-360m (through ``cfg_overrides``) on a [2, 32] batch,
and a ``long_500k`` SKIP.  The planted faults: a cell whose trace
raises, a status count off, an LM cell counted below the arithmetic its
model needs, an output dtype off the abstract trace's, a first-step
gradient off the plain path (GCN) or off the float64 one (PNA), a wrong
id out of the packed decode, a packed loss off the int64 path, an
attention row off float64, a launch one short of the step's
requests, a NaN loss and a collective on a world of one."""

from _torch_env import load_chip_smoke  # first: one torch thread
import functools

import pytest
import torch


@pytest.fixture(scope="module")
def smoke():
    return load_chip_smoke()


def _lm_over():
    from repro_torch.configs import get_arch
    red = get_arch("smollm-360m").make_reduced()
    return {k: getattr(red, k) for k in (
        "n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff",
        "vocab")}


def _cells():
    return [("gcn-cora", "molecule", "baseline"),
            ("pna", "molecule", "baseline"),
            ("gcn-cora", "full_graph_sm", "edges_compbin"),
            ("smollm-360m", "prefill_32k", "baseline",
             {"cfg_overrides": _lm_over()}),
            ("smollm-360m", "long_500k", "baseline")]


def _phase(smoke, cells=None, **kw):
    return smoke.phase_cells("cpu", jobs=1, cells=cells or _cells(),
                             expect=None, free_bytes=1 << 40, reps=1,
                             lm_shape=(2, 32), **kw)


@pytest.fixture(scope="module")
def phase(smoke):
    return _phase(smoke)


def test_cells_phase_on_cpu(smoke, phase):
    r = phase
    assert [x["status"] for x in r["records"]] == ["OK"] * 4 + ["SKIP"]
    assert len(r["runs"]) == 4 and not r["not_run"]
    assert r["main_launches"] == r["check_launches"] == \
        {"k1": 0, "k2": 0, "k2_grad": 0, "k3": 0}
    by = {(x["arch"], x["shape"], x["variant"]): x for x in r["runs"]}
    gcn = by[("gcn-cora", "molecule", "baseline")]
    assert gcn["parity"]["loss_rel_err"] == 0.0
    assert gcn["parity"]["cpu_loss_rel_err"] == 0.0
    pna = by[("pna", "molecule", "baseline")]["parity"]
    assert max(pna["kernel_relative_distance"],
               pna["plain_relative_distance"]) <= smoke.CELL_GRAD_SHARE
    packed = by[("gcn-cora", "full_graph_sm", "edges_compbin")]
    assert packed["ids_checked"] == 2 * 10_752
    assert packed["parity"]["loss_rel_err"] == 0.0
    assert max(packed["parity"]["grad_max_abs_err"].values()) < 1e-6
    pre = by[("smollm-360m", "prefill_32k", "baseline")]
    assert pre["shadow_calls"] == _lm_over()["n_layers"]
    assert pre["shadow_worst_err_over_atol"] < 1.0
    for x in r["runs"]:
        assert not x["profile"]["collectives"]["ops"]
    rec = r["records"][3]
    assert rec["kernels_counted_as"] == "plain" and rec["arith_ratio"] <= 1
    for rec in r["records"]:
        smoke.log_cell_record(rec)
    for x in r["runs"]:
        smoke.log_cell_run(x)


def test_the_full_catalog_statuses(smoke):
    """On all 40 cells (records of the GNN and DIN cells traced here,
    the LM cells' statuses as the card run expects them) the status
    check passes; one SKIP short fails it."""
    recs = [{"arch": "a", "shape": str(i), "variant": "baseline",
             "status": "OK" if i < 35 else "SKIP", "family": "gnn"}
            for i in range(40)]
    assert smoke.check_dry_run(recs) == smoke.CELL_STATUS
    with pytest.raises(AssertionError, match="dry-run statuses"):
        smoke.check_dry_run(recs[:-1])


def test_a_failing_trace_fails_the_phase(smoke, monkeypatch):
    from repro_torch.models.gnn import gcn

    def broken(params, batch, cfg):
        raise RuntimeError("planted")

    monkeypatch.setattr(gcn, "loss_fn", broken)
    with pytest.raises(AssertionError, match="(?s)dry run FAIL.*planted"):
        _phase(smoke, cells=_cells()[:1])


def test_lm_flops_below_the_model_fail(smoke, phase):
    rec = dict(phase["records"][3])
    rec["cost"] = dict(rec["cost"], flops=rec["cost"]["flops"] * 0.1)
    with pytest.raises(AssertionError, match="the model needs"):
        smoke.check_dry_run([rec], None, [_cells()[3]])


def _run(smoke, phase, i, **kw):
    from repro_torch.launch.mesh import card_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.variants import apply_variant
    job = _cells()[i]
    build = {**apply_variant(*job[:3]), **(job[3] if len(job) > 3 else {})}
    cell = build_cell(job[0], job[1], card_mesh(), **build)
    return cell, functools.partial(
        smoke.run_cell_on_device, cell, phase["records"][i], "cpu", reps=1,
        lm_shape=(2, 32), **kw)


def test_output_dtype_off_the_trace_fails(smoke, phase):
    cell, run = _run(smoke, phase, 0)
    real = cell.fn

    def wrong(state, batch):
        new, met = real(state, batch)
        return new, dict(met, loss=met["loss"].double())

    cell.fn = wrong
    with pytest.raises(AssertionError, match="abstract trace's"):
        run()


def test_first_step_gradient_off_fails(smoke, phase, monkeypatch):
    from repro_torch.models.gnn import layers
    real = layers.segment_sum
    monkeypatch.setattr(layers, "segment_sum",
                        lambda m, i, n: real(m, i, n) * (1 + 1e-3))
    _, run = _run(smoke, phase, 0, parity=True)
    with pytest.raises(AssertionError, match="first-step"):
        run()


def test_float64_held_gradient_off_fails(smoke, phase, monkeypatch):
    """PNA's first step against the float64 plain path: a 1 % error in
    the gradient of every segment sum of the kernel path (the forward
    exact) is past ``CELL_GRAD_SHARE``."""
    from repro_torch.models.gnn import layers

    class GradOff(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g * (1 + 1e-2)

    real = layers.segment_sum
    monkeypatch.setattr(layers, "segment_sum",
                        lambda m, i, n: real(GradOff.apply(m), i, n))
    _, run = _run(smoke, phase, 1, parity=True)
    with pytest.raises(AssertionError, match="from float64"):
        run()


def test_wrong_packed_ids_fail(smoke, phase, monkeypatch):
    """A wrong id out of the decode op the step calls (planted where
    ``steps._gnn_loss`` imports it) fails the ids check."""
    import repro_torch.kernels.compbin_decode as k1
    real = k1.compbin_decode

    def off_by_one(packed, b):
        return real(packed, b) + 1

    monkeypatch.setattr(k1, "compbin_decode", off_by_one)
    _, run = _run(smoke, phase, 2)
    with pytest.raises(AssertionError, match="differ from decode_ids"):
        run()


def test_packed_loss_off_the_int64_path_fails(smoke, phase, monkeypatch):
    """A packed cell's loss that maps the pad id to node 0, not -1 (the
    ids check passes: it decodes through ``decode_packed_edges``), fails
    the first step held to the plain path fed the int64 ids."""
    from repro_torch.launch import steps
    real = steps._gnn_loss

    def pads_to_zero(params, batch, *, mod, cfg, static, cb_b=0):
        if not cb_b:
            return real(params, batch, mod=mod, cfg=cfg, static=static)
        full = steps.decode_packed_edges(batch, cb_b)
        for key in ("edge_src", "edge_dst"):
            full[key] = full[key].clamp(min=0)
        return real(params, full, mod=mod, cfg=cfg, static=static)

    monkeypatch.setattr(steps, "_gnn_loss", pads_to_zero)
    _, run = _run(smoke, phase, 2, parity=True)
    with pytest.raises(AssertionError, match="first-step"):
        run()


def test_attention_row_off_float64_fails(smoke, phase, monkeypatch):
    from repro_torch.models import transformer as tf
    real = tf.attention
    monkeypatch.setattr(tf, "attention",
                        lambda *a, **k: real(*a, **k) * 2)
    _, run = _run(smoke, phase, 3)
    with pytest.raises(AssertionError, match="attention row"):
        run()


def test_launch_count_off_fails(smoke, phase, monkeypatch):
    """The step's first segment sum counted as asked of the card (the
    device check true once) where no kernel launched."""
    asks = iter([True])
    monkeypatch.setattr(smoke, "_on_card", lambda t: next(asks, False))
    _, run = _run(smoke, phase, 0)
    with pytest.raises(AssertionError, match="launches"):
        run()


def test_nan_loss_fails(smoke, phase, monkeypatch):
    from repro_torch.models.gnn import gcn
    real = gcn.loss_fn
    monkeypatch.setattr(gcn, "loss_fn",
                        lambda p, b, c: real(p, b, c) * float("nan"))
    _, run = _run(smoke, phase, 0)
    with pytest.raises(AssertionError, match="losses"):
        run()


def test_a_collective_on_a_world_of_one_fails(smoke, phase, monkeypatch):
    from repro_torch.launch import hlo_analysis as hla
    real = hla.collectives_from_profile

    def one_op(prof, sizes):
        st = real(prof, sizes)
        st.ops["all-reduce"] = 1
        return st

    monkeypatch.setattr(hla, "collectives_from_profile", one_op)
    _, run = _run(smoke, phase, 0)
    with pytest.raises(AssertionError, match="collectives on a world"):
        run()


def test_lookup_flops_of_the_catalog(smoke):
    """The model FLOPs no program does as arithmetic: smollm-360m ties
    its embedding (train: 0), stablelm-1.6b does not."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import LM_SHAPES
    sm = get_arch("smollm-360m").make_config()
    st = get_arch("stablelm-1.6b").make_config()
    tr, pre = LM_SHAPES["train_4k"], LM_SHAPES["prefill_32k"]
    assert smoke.lm_lookup_flops(sm, tr) == 0.0
    assert smoke.lm_lookup_flops(st, tr) == \
        6.0 * st.vocab * st.d_model * 256 * 4096
    assert smoke.lm_lookup_flops(sm, pre) == \
        2.0 * sm.vocab * sm.d_model * 32 * 32767
    packed = smoke.pack_ids(torch.tensor([0, 258, -1]), 2)
    assert packed.tolist() == [0, 0, 2, 1, 255, 255]
