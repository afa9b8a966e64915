"""Each cell rehearsed on the CPU at a small size through the harness's
own run (``run.execute``: set-up, window, readers, check; only the look
for a card is skipped), then run again with the timed path broken
underneath: every planted fault must turn ``correct`` false."""

import time

import numpy as np
import pytest
import torch

from perfbench import run
from perfbench.tests.conftest import TINY


def execute(bench, workload, trace=False, seed=20260001, seconds=0.5):
    return run.execute(bench, workload, seed, seconds, trace, "cpu",
                       t_start=time.perf_counter(), updates=TINY[workload])


E2E = {"load.g500-24": {"load_edges_per_s", "setup_s"},
       "query.g500-24.uniform": {"query_vertices_per_s", "query_p95_ms",
                                 "setup_s"},
       "query.g500-24.hubs": {"query_vertices_per_s", "query_p95_ms",
                              "setup_s"},
       "train.gcn-products.full": {"gcn_step_ms", "setup_s"}}
# the per-layer metrics a CPU run can read (no device trace here)
LAYER = {"load.g500-24": {"stage_share.load"},
         "query.g500-24.uniform": {"gather_ms.query", "decode_ms.query",
                                   "storage_ms.query",
                                   "hotset_hit_rate.query"},
         "query.g500-24.hubs": {"gather_ms.query", "decode_ms.query",
                                "storage_ms.query", "hotset_hit_rate.query"},
         "train.gcn-products.full": {"gcn_step_mfu"}}


@pytest.mark.parametrize("workload", sorted(TINY))
def test_cell_rehearses_on_the_cpu(bench, workload):
    out = execute(bench, workload)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == E2E[workload]
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    traced = execute(bench, workload, trace=True, seed=20260002)
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == LAYER[workload]
    assert "breakdown" in traced and traced["device"]["window_s"] > 0


def _flip_first(ids):
    out = ids.clone()
    if out.numel():
        out.view(-1)[0] ^= 1
    return out


def test_load_with_a_flipped_id_fails(bench, monkeypatch):
    import repro_torch.kernels.compbin_decode as k1
    real = k1.compbin_decode
    monkeypatch.setattr(k1, "compbin_decode",
                        lambda p, b: _flip_first(real(p, b)))
    out = execute(bench, "load.g500-24")
    assert not out["correct"] and out["checks"]["load_ids_wrong"]["value"] > 0


def test_load_with_a_dropped_edge_fails(bench, monkeypatch):
    import repro_torch.kernels.compbin_decode as k1
    real = k1.pad_packed_for_stream

    def drop_last(raw, b, **kw):
        return real(raw[:-b] if raw.size >= b else raw, b, **kw)

    monkeypatch.setattr(k1, "pad_packed_for_stream", drop_last)
    out = execute(bench, "load.g500-24")
    assert not out["correct"]


def _patch_answers(monkeypatch, alter):
    from repro_torch.query.engine import NeighborQueryEngine
    real = NeighborQueryEngine.neighbors_batch

    def broken(self, vertices, **kw):
        return alter(real(self, vertices, **kw))

    monkeypatch.setattr(NeighborQueryEngine, "neighbors_batch", broken)


@pytest.mark.parametrize("workload", ["query.g500-24.uniform",
                                      "query.g500-24.hubs"])
def test_query_with_an_altered_answer_fails(bench, monkeypatch, workload):
    def alter(res):
        for i, a in enumerate(res):
            if a.size:
                a = a.copy()
                a[0] ^= 1
                res[i] = a
                break
        return res

    _patch_answers(monkeypatch, alter)
    out = execute(bench, workload)
    assert not out["correct"] and out["checks"]["query_ids_wrong"]["value"] > 0


@pytest.mark.parametrize("workload", ["query.g500-24.uniform",
                                      "query.g500-24.hubs"])
def test_query_with_reordered_answers_fails(bench, monkeypatch, workload):
    def alter(res):
        for i in range(len(res) - 1):
            if not np.array_equal(res[i], res[i + 1]):
                res[i], res[i + 1] = res[i + 1], res[i]
                break
        return res

    _patch_answers(monkeypatch, alter)
    out = execute(bench, workload)
    assert not out["correct"]


def test_query_with_failing_requests_fails(bench, monkeypatch):
    def alter(res):
        raise OSError("planted storage error")

    _patch_answers(monkeypatch, alter)
    out = execute(bench, "query.g500-24.uniform")
    assert not out["correct"] and out["failed"] > 0


def test_training_step_that_returns_its_state_fails(bench, monkeypatch):
    from repro_torch.launch import steps

    def unchanged(params, grads, state, cfg):
        return params, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(())}

    monkeypatch.setattr(steps, "adamw_update", unchanged)
    out = execute(bench, "train.gcn-products.full")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_training_on_half_the_batch_fails(bench, monkeypatch):
    from repro_torch.models.gnn import gcn
    real = gcn.loss_fn

    def half(params, batch, cfg):
        mask = batch["label_mask"].clone()
        mask[1::2] = False
        return real(params, dict(batch, label_mask=mask), cfg)

    monkeypatch.setattr(gcn, "loss_fn", half)
    out = execute(bench, "train.gcn-products.full")
    assert not out["correct"] and out["checks"]["grad_gap"]["value"] > \
        out["checks"]["grad_gap"]["limit"]


def test_training_in_bf16_fails(bench, monkeypatch):
    from repro_torch.models.gnn import gcn
    real = gcn.forward

    def bf16(params, batch, cfg):
        # weights, features and logits held in bfloat16
        low = lambda t: t.to(torch.bfloat16).float()
        x = dict(batch, x=low(batch["x"]))
        return low(real({k: low(v) for k, v in params.items()}, x, cfg))

    monkeypatch.setattr(gcn, "forward", bf16)
    out = execute(bench, "train.gcn-products.full")
    assert not out["correct"], out["checks"]


def test_training_starts_from_the_benchmarks_own_weights(bench):
    """The program's state and the reference start from the weights that
    ``perfbench/gen/weights.py`` draws, not from the program's init."""
    from perfbench.drivers import train
    from perfbench.gen import weights
    _, cfg, traffic = run.cell_files(bench, "train.gcn-products.full",
                                     updates=TINY["train.gcn-products.full"])
    cell = train.Cell(cfg, traffic, 20260003, "cpu", False)
    want = weights.gcn_params(cfg["d_in"], cfg["d_hidden"],
                              cfg["n_classes"], 20260003 + 2, "cpu")
    assert set(cell.params0) == set(want)
    assert all(torch.equal(cell.params0[k], want[k]) for k in want)
    with pytest.raises(ValueError):
        train._fits(dict(want, w1=want["w1"].T),
                    {k: v.to("meta") for k, v in want.items()})
