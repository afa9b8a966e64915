"""The plain references, and proof that each comparison can fail."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench.gen import kronecker
from perfbench.reference import csr as ref_csr
from perfbench.reference import gcn as ref_gcn


@pytest.fixture(scope="module")
def graph():
    return kronecker.graph500_csr(10, 16, 4242, "cpu")


def shards_of(offsets, neighbors, cuts=(0, 300, 301, 1024)):
    out = []
    for a, z in zip(cuts[:-1], cuts[1:]):
        lo, hi = int(offsets[a]), int(offsets[z])
        out.append(SimpleNamespace(v0=a, v1=z,
                                   offsets=(offsets[a:z + 1] - lo).clone(),
                                   neighbors=neighbors[lo:hi].clone()))
    return out


def test_exact_shards_pass(graph):
    assert ref_csr.shard_mismatches(shards_of(*graph), *graph) == 0


def test_a_flipped_id_fails(graph):
    s = shards_of(*graph)
    s[2].neighbors[7] ^= 1
    assert ref_csr.shard_mismatches(s, *graph) == 1


def test_a_dropped_edge_fails(graph):
    s = shards_of(*graph)
    s[0].neighbors = s[0].neighbors[:-1]
    assert ref_csr.shard_mismatches(s, *graph) >= 1


def test_a_missing_or_overlapping_shard_fails(graph):
    s = shards_of(*graph)
    assert ref_csr.shard_mismatches(s[:2], *graph) > 0
    assert ref_csr.shard_mismatches(s + s[1:2], *graph) > 0


def test_the_control_shards_fail(graph):
    off, nbr = graph
    ctl = ref_csr.control_shards(shards_of(off, nbr), off, nbr, 2)
    assert ref_csr.shard_mismatches(ctl, off, nbr) == int((nbr >= 256).sum())


def answers_of(graph, vs):
    off, nbr = (t.numpy() for t in graph)
    return [nbr[off[v]:off[v + 1]].astype(np.int64) for v in vs], off, nbr


def test_exact_answers_pass(graph):
    vs = np.array([5, 0, 5, 1023, 17])
    ans, off, nbr = answers_of(graph, vs)
    assert ref_csr.answer_mismatches(vs, ans, off, nbr) == 0


def test_a_flipped_answer_id_fails(graph):
    vs = np.array([5, 0, 17])
    ans, off, nbr = answers_of(graph, vs)
    ans[1] = ans[1].copy()
    ans[1][0] ^= 1
    assert ref_csr.answer_mismatches(vs, ans, off, nbr) == 1


def test_a_reordered_answer_fails(graph):
    vs = np.array([0, 1, 2, 3])
    ans, off, nbr = answers_of(graph, vs)
    ans[0], ans[1] = ans[1], ans[0]
    assert ref_csr.answer_mismatches(vs, ans, off, nbr) > 0


def test_answers_not_int64_or_missing_fail(graph):
    vs = np.array([0, 1])
    ans, off, nbr = answers_of(graph, vs)
    assert ref_csr.answer_mismatches(vs, [ans[0].astype(np.int32), ans[1]],
                                     off, nbr) == 1
    assert ref_csr.answer_mismatches(vs, ans[:1], off, nbr) > 0


def test_the_control_answers_fail(graph):
    vs = np.arange(1024)
    _, off, nbr = answers_of(graph, vs)
    ctl = ref_csr.control_answers(vs, off, nbr, 2)
    assert ref_csr.answer_mismatches(vs, ctl, off, nbr) == int((nbr >= 256).sum())


def gcn_inputs(seed=3, n=600, e=5000, d=32, c=5):
    g = torch.Generator().manual_seed(seed)
    src, dst = kronecker.bounded_edges(n, e, 10, seed, "cpu")
    pad = 64
    batch = {"x": torch.randn(n, d, generator=g),
             "edge_src": torch.cat([src, torch.full((pad,), -1)]).int(),
             "edge_dst": torch.cat([dst, torch.full((pad,), -1)]).int(),
             "labels": torch.randint(0, c, (n,), generator=g).int(),
             "label_mask": torch.rand(n, generator=g) < 0.3}
    params = {"w0": torch.randn(d, 16, generator=g) * d ** -0.5,
              "b0": torch.zeros(16),
              "w1": torch.randn(16, c, generator=g) * 0.25,
              "b1": torch.zeros(c)}
    opt = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "clip_norm": 1.0, "warmup_steps": 100,
           "total_steps": 10000, "min_lr_frac": 0.1}
    return params, batch, opt


def test_gcn_reference_follows_the_ports_step():
    """The port's own cell step, fed the same weights and inputs, reads
    within float32 rounding of the reference."""
    from repro_torch.launch.steps import _train_step
    from repro_torch.models.gnn import gcn
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    params, batch, opt = gcn_inputs()
    cfg = gcn.GCNConfig(d_in=32, n_classes=5)
    step = _train_step(lambda p, b: gcn.loss_fn(p, b, cfg), AdamWConfig())
    state = {"params": {k: v.clone() for k, v in params.items()},
             "opt": adamw_init(params, AdamWConfig())}
    losses = []
    for t in range(3):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        if t == 0:
            first = {k: m / 0.1 for k, m in state["opt"]["m"].items()}
    prog = {"losses": losses, "first_grad": first, "params": state["params"]}
    ref = ref_gcn.train(params, batch, opt)
    r = ref_gcn.readings(prog, ref, params)
    assert r["loss_gap"] < 1e-6 and r["grad_gap"] < 1e-5 \
        and r["change_gap"] < 1e-4, r


def test_a_bf16_gcn_step_fails():
    params, batch, opt = gcn_inputs()
    ref = ref_gcn.train(params, batch, opt)
    low = ref_gcn.train(params, batch, opt, precision="bfloat16")
    r = ref_gcn.readings(low, ref, params)
    from perfbench.drivers.train import LIMITS
    assert any(r[k] > LIMITS[k] for k in LIMITS), r


def test_an_unchanged_state_fails():
    params, batch, opt = gcn_inputs()
    ref = ref_gcn.train(params, batch, opt)
    still = {"losses": ref["losses"][:1] * 3,
             "first_grad": {k: torch.zeros_like(v) for k, v in params.items()},
             "params": params}
    r = ref_gcn.readings(still, ref, params)
    assert r["grad_gap"] == pytest.approx(1.0)
    assert r["change_gap"] == pytest.approx(1.0)
