"""The PNA training cell rehearsed on the CPU at a small size through
the harness's own run, then with the step broken underneath: every
planted fault must turn ``correct`` false, and the control must fail
where the program passes."""

import time

import pytest
import torch

from perfbench import run

CELL = "train.pna-arxiv.full"
#: PNA at its full widths on Cora's size: 2,708 nodes, 5,278 Kronecker
#: edges at scale 12 written both ways, 140 training nodes; arxiv's 128
#: features and 40 classes
SMALL = {"config": {"n_nodes": 2708, "n_edges": 10556, "train_nodes": 140,
                    "edges": {"scale": 12, "seed": 0}}}


def execute(bench, trace=False, seed=20260021, seconds=0.5):
    return run.execute(bench, CELL, seed, seconds, trace, "cpu",
                       t_start=time.perf_counter(), updates=SMALL)


def test_the_pna_cell_rehearses_on_the_cpu(bench):
    out = execute(bench)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"gcn_step_ms", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"grad_gap", "change_gap",
                                  "steps_not_finite"}
    traced = execute(bench, trace=True, seed=20260022)
    assert traced["correct"], traced["checks"]
    # no device trace on the CPU: the step's share of the peak alone
    assert set(traced["metrics"]) == {"pna_step_mfu"}
    assert "breakdown" in traced and traced["device"]["window_s"] > 0


def _fails(out, *names):
    assert not out["correct"], out["checks"]
    c = out["checks"]
    assert any(c[n]["value"] > c[n]["limit"] for n in names), c


def test_a_zeroed_std_fails(bench, monkeypatch):
    from repro_torch.models.gnn import layers
    monkeypatch.setattr(layers, "scatter_std",
                        lambda m, dst, n: m.new_zeros((n, m.shape[1])))
    _fails(execute(bench), "grad_gap", "change_gap")


def test_swapped_scalers_fail(bench, monkeypatch):
    from repro_torch.models.gnn import pna
    real = pna.scalers

    def swapped(deg, cfg):
        amp, att = real(deg, cfg)
        return att, amp

    monkeypatch.setattr(pna, "scalers", swapped)
    _fails(execute(bench), "grad_gap", "change_gap")


def test_training_on_half_the_batch_fails(bench, monkeypatch):
    from repro_torch.models.gnn import pna
    real = pna.loss_fn

    def half(params, batch, cfg):
        mask = batch["label_mask"].clone()
        mask[torch.nonzero(mask).flatten()[1::2]] = False
        return real(params, dict(batch, label_mask=mask), cfg)

    monkeypatch.setattr(pna, "loss_fn", half)
    _fails(execute(bench), "grad_gap")


def test_a_bf16_forward_fails(bench, monkeypatch):
    from repro_torch.models.gnn import pna
    real = pna.forward

    def bf16(params, batch, cfg):
        # weights, features and logits held in bfloat16
        low = lambda t: t.to(torch.bfloat16).float()
        x = dict(batch, x=low(batch["x"]))
        return low(real({k: low(v) for k, v in params.items()}, x, cfg))

    monkeypatch.setattr(pna, "forward", bf16)
    _fails(execute(bench), "grad_gap", "change_gap")


def test_a_step_that_returns_its_state_fails(bench, monkeypatch):
    from repro_torch.launch import steps

    def unchanged(params, grads, state, cfg):
        return params, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(())}

    monkeypatch.setattr(steps, "adamw_update", unchanged)
    out = execute(bench)
    _fails(out, "change_gap")
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_the_control_fails_where_the_program_passes(bench):
    from perfbench import control
    r = control.readings(bench, CELL, 20260023, 0.5, "cpu", updates=SMALL)
    assert r["program"]["correct"], r
    assert set(r) == {"program", "reference_in_bfloat16", "half_batch"}
    assert not r["reference_in_bfloat16"]["correct"]
    assert not r["half_batch"]["correct"]


def test_the_cell_starts_from_the_benchmarks_own_weights_and_delta(bench):
    """The program's state and the reference start from the weights that
    ``perfbench/gen/pna_weights.py`` draws, and the port's step uses the
    drawn graph's degree constant, not PNAConfig's default."""
    from perfbench.drivers import train_pna
    from perfbench.gen import pna_weights
    from perfbench.reference import pna as ref_pna
    _, cfg, traffic = run.cell_files(bench, CELL, updates=SMALL)
    cell = train_pna.Cell(cfg, traffic, 20260024, "cpu", False)
    want = pna_weights.pna_params(cfg["d_in"], cfg["d_hidden"],
                                  cfg["n_classes"], cfg["n_layers"],
                                  20260024 + 2, "cpu")
    assert set(cell.params0) == set(want) and len(want) == 4 + 4 * 4
    assert all(torch.equal(cell.params0[k], want[k]) for k in want)
    assert cell.delta == ref_pna.avg_log_degree(cell.batch["edge_dst"],
                                                cfg["n_nodes"])
    assert cell.delta != 2.0 and 0 < cell.delta < 5


def test_the_step_flops_are_the_ports_formula():
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import GNNShape
    from repro_torch.launch.model_flops import gnn_model_flops

    from perfbench.gen import pna_arith
    for n, e, f, c in ((169343, 2332486, 128, 40), (2708, 10556, 1433, 7)):
        cfg = get_arch("pna").make_config(d_in=f, n_classes=c)
        assert pna_arith.pna_step_flops(n, e, f, cfg.d_hidden,
                                        cfg.n_layers) == \
            gnn_model_flops("pna", cfg, GNNShape("s", n, e, f, c))


def test_the_readers_count_the_documented_bytes_and_operations():
    """The byte counts a step: two sums a layer at D 75 (K2 and its
    backward), and the arxiv step's 9.37e11 operations."""
    from types import SimpleNamespace

    from perfbench.gen import arith, devtrace, pna_arith
    ctx = SimpleNamespace(counters={
        "steps": 2, "step_s": 0.25, "n_layers": 4, "d_hidden": 75,
        "e_slots": 2332672, "n_slots": 169472, "valid_edges": 2332486,
        "grad_rows": 160000,
        "flops": pna_arith.pna_step_flops(169343, 2332486, 128, 75, 4)},
        trace=devtrace.DeviceTrace(window_s=0.5, device=[
            devtrace.Op("k2_atomic_f32", "kernel", 0.0, 0.01),
            devtrace.Op("k2_grad_vec1", "kernel", 0.02, 0.004),
            devtrace.Op("void at::native::indexFuncLargeIndex<float, long, "
                        "unsigned int, 2, 2, -2, true, "
                        "at::native::ReduceMaximum>", "kernel", 0.03,
                        0.002)]))
    k2 = run.reader("k2_roofline.pna")(ctx)
    want = 100 * 2 * 2 * 4 * arith.k2_bytes(2332672, 75, 169472, 2332486) \
        / arith.HBM_BYTES_PER_S / 0.01
    assert k2 == pytest.approx(want)
    grad = run.reader("k2_grad_roofline.pna")(ctx)
    assert grad == pytest.approx(100 * 2 * 2 * 4 * arith.k2_grad_bytes(
        2332672, 75, 160000) / arith.HBM_BYTES_PER_S / 0.004)
    assert run.reader("minmax_ms.pna")(ctx) == pytest.approx(1.0)
    assert run.reader("pna_step_mfu")(ctx) == pytest.approx(
        100 * 9.367223418e11 / 0.25 / 67e12)
    # the device's idle share is the GCN cell's reader, read here too
    assert run.reader("idle_share.gcn")(ctx) == pytest.approx(
        100 * (0.5 - 0.016) / 0.5)
    # the GCN cell's context (no n_layers) reads nothing here
    gcn = SimpleNamespace(trace=ctx.trace, counters={
        k: v for k, v in ctx.counters.items() if k != "n_layers"})
    for name in ("k2_roofline.pna", "k2_grad_roofline.pna",
                 "minmax_ms.pna", "pna_step_mfu"):
        assert run.reader(name)(gcn) is None
