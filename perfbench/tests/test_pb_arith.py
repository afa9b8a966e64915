"""The frozen yardstick arithmetic on known shapes, and the readers on
synthetic traces."""

import json
from types import SimpleNamespace

import pytest

from perfbench import run
from perfbench.gen import arith
from perfbench.gen.devtrace import DeviceTrace, Op, read_chrome_trace


def bound_ms(nbytes):
    return nbytes / arith.HBM_BYTES_PER_S * 1e3


# PERF.md §6's kernel table: (bytes formula's inputs, its bound in ms)
@pytest.mark.parametrize("n, b, want", [(16_416_768, 3, 0.0343),
                                        (8_192_000, 3, 0.0171),
                                        (1 << 28, 4, 0.6410),
                                        (1 << 28, 1, 0.4006)])
def test_k1_bytes_match_the_kernel_table(n, b, want):
    assert bound_ms(arith.k1_bytes(n, b)) == pytest.approx(want, abs=1e-4)


@pytest.mark.parametrize("e, d, n, valid, want", [
    (30720, 1433, 31744, 16436, 0.0825),                 # served layer 0
    (61_859_328, 16, 2_449_152, 61_859_140, 1.3024),    # ogbn-products
    (3_939_466, 16, 262_144, 3_939_466, 0.0850),        # full graph D 16
])
def test_k2_bytes_match_the_kernel_table(e, d, n, valid, want):
    assert bound_ms(arith.k2_bytes(e, d, n, valid)) == \
        pytest.approx(want, abs=1e-4)


@pytest.mark.parametrize("e, d, rows, want", [
    (3_939_466, 16, 148_526, 0.0828),            # full graph layer 1
    (61_859_328, 16, 2_449_029, 1.3024),         # ogbn-products
])
def test_k2_grad_bytes_match_the_kernel_table(e, d, rows, want):
    assert bound_ms(arith.k2_grad_bytes(e, d, rows)) == \
        pytest.approx(want, abs=1e-4)


def test_gcn_flops_equal_the_ports_model_flops():
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.launch.model_flops import gnn_model_flops
    shape = GNN_SHAPES["ogb_products"]
    cfg = get_arch("gcn-cora").make_config(d_in=shape.d_feat,
                                           n_classes=shape.n_classes)
    want = gnn_model_flops("gcn-cora", cfg, shape)
    got = arith.gcn_step_flops(shape.n_nodes, shape.n_edges, shape.d_feat,
                               cfg.d_hidden, shape.n_classes)
    assert got == want


def _trace():
    """A 10 s window: device busy over [1, 3) and [2, 4) (overlapping)
    and [6, 7); host op ``aten::copy_`` over [4, 6)."""
    dev = [Op("decode_vec4<3>", "kernel", 1.0, 2.0),
           Op("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 2.0, 2.0,
              nbytes=8_000_000_000),
           Op("k2_grad<int, 4>", "kernel", 6.0, 1.0)]
    host = [Op("aten::copy_", "cpu_op", 4.0, 2.0)]
    return DeviceTrace(window_s=10.0, device=dev, host=host)


def test_busy_time_is_the_union_of_device_intervals():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(4.0)
    ctx = SimpleNamespace(trace=tr, counters={})
    for cell in ("load", "query", "gcn"):
        assert run.reader(f"idle_share.{cell}")(ctx) == pytest.approx(60.0)
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(2.0)
    assert tr.top_device_ops()[0][0] == "decode_vec4<3>"


def test_readers_of_the_trace():
    ctx = SimpleNamespace(trace=_trace(), counters={
        "edges": 1_000_000_000, "b": 3, "decode_s": 2.0, "wall_s": 8.0})
    assert run.reader("h2d_gbps.load")(ctx) == pytest.approx(4.0)
    assert run.reader("stage_share.load")(ctx) == pytest.approx(25.0)
    want = 100 * 7e9 / arith.HBM_BYTES_PER_S / 2.0
    assert run.reader("k1_roofline.load")(ctx) == pytest.approx(want)


def test_readers_find_nothing_and_say_so():
    empty = SimpleNamespace(trace=DeviceTrace(window_s=1.0), counters={})
    for m in ("idle_share.load", "h2d_gbps.load", "k1_roofline.load",
              "stage_share.load", "gather_ms.query", "hotset_hit_rate.query",
              "gcn_step_mfu", "k2_roofline.gcn", "k2_grad_roofline.gcn"):
        assert run.reader(m)(empty) is None, m


def test_chrome_trace_is_read(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k2_atomic<int>", "ts": 1e6,
         "dur": 500.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 2e6,
         "dur": 1000.0, "args": {"bytes": 4096}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 3.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0}]}))
    tr = read_chrome_trace(str(p), 3.0)
    assert [o.name for o in tr.device] == ["k2_atomic<int>", "Memcpy HtoD"]
    assert tr.device[1].nbytes == 4096
    assert tr.seconds(tr.kernels("k2_")) == pytest.approx(5e-4)
    assert [o.name for o in tr.host] == ["aten::mm"]


def test_every_metric_has_a_reader_and_every_cell_its_files(bench):
    from perfbench.run import ROOT, cell_files
    for m in bench["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    for w in bench["workloads"]:
        wl, cfg, traffic = cell_files(bench, w["name"])
        assert cfg["name"] == w["config"]
        assert (ROOT / "perfbench" / "drivers"
                / f"{traffic['driver']}.py").is_file()
