"""On the card: each cell's harness at a small size, correct, with its
per-layer metrics read from the device trace."""

import time

import pytest

from perfbench import run

SMALL = {
    "load.g500-24": {"config": {"scale": 16}},
    "query.g500-24.hubs": {"config": {"scale": 16},
                           "traffic": {"warmup_requests": 4}},
    "train.gcn-products.full": {"config": {
        "shape": "full_graph_sm", "n_nodes": 2708, "n_edges": 10556,
        "d_in": 1433, "n_classes": 7, "train_nodes": 140,
        "edges": {"scale": 12, "seed": 0}}},
}


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_cell_on_the_card(bench, cuda, workload):
    out = run.execute(bench, workload, 20260201, 2.0, True, cuda,
                      t_start=time.perf_counter(), updates=SMALL[workload])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    for name, m in out["metrics"].items():
        if name.endswith("roofline") or "roofline." in name or "mfu" in name:
            assert 0 < m["value"] <= 105, (name, m)
