"""The port's PNA against the benchmark's plain reference
(``perfbench/reference/pna.py``: PNA written from the paper's equations
in plain torch, the same file the benchmark's PNA cell compares with on
the card), on the CPU at PNA's full widths (4 layers, d_hidden 75) on
small Kronecker graphs.

Each graph has padding (-1 at both ends), ids at or above N in the
destination (dropped), nodes with no in-edge (empty segments) and
duplicated edges, whose equal messages tie every maximum and minimum.
Tolerances, each from what these cases read:

* logits and loss: float32 on the CPU sums in edge order on both sides,
  so they agree to rounding (1e-6 of the largest logit, the loss to 1e-6
  relative; read: 0 to 2e-7);
* gradients: the std's ``E[m^2] - E[m]^2`` cancels, so both float32
  gradients lie up to 1e-3 of a leaf's largest element from a float64
  run; the port is held within 2e-5 of a leaf's largest element of the
  float32 reference (read: up to 4.5e-6), and no farther from the
  float64 run than twice the reference is, plus 1e-6 of the largest
  gradient (``chip_smoke.py::exact_close``'s rule);
* three AdamW steps through ``build_cell`` with a ``GNNShape`` outside
  the catalog, read as the benchmark cell reads them: ``grad_gap`` under
  1e-5 (read: up to 5.7e-7) and ``change_gap`` under 1e-4 (read: up to
  1.8e-5: Adam's first steps take the sign of gradients near zero).

Also: the catalog is unchanged by a shape outside it, and PNA's phases
are profiler ranges only while a profiler records, with the logits'
bits unchanged.
"""

import _torch_env  # noqa: F401  (first: one torch thread)
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.gen import kronecker, pna_weights  # noqa: E402
from perfbench.reference import gcn as ref_gcn  # noqa: E402
from perfbench.reference import pna as ref  # noqa: E402
from repro_torch.configs import all_cells  # noqa: E402
from repro_torch.configs.shapes import (EDGE_PAD, GNN_SHAPES,  # noqa: E402
                                        NODE_PAD, GNNShape, _pad)
from repro_torch.launch.mesh import card_mesh  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models.gnn import pna  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402

D_IN, N_CLASSES, N_REAL = 16, 5, 400
OPT = json.loads((ROOT / "perfbench" / "configs" /
                  "pna.ogbn-arxiv.json").read_text())["optimizer"]
#: (n_layers, d_hidden): PNA's full widths, and the port's reduced config
WIDTHS = {"full": (4, 75), "reduced": (2, 12)}
SEEDS = (1, 2, 3)


def make_batch(seed: int, scale: int = 9) -> dict:
    """A padded PNA batch over ``N_REAL`` real nodes: 4 Kronecker edges a
    node, the first 20 duplicated (tied messages), 5 edges into an id
    past N (dropped), the rest -1 at both ends."""
    gen = kronecker.generator(seed, "cpu")
    src, dst = kronecker.bounded_edges(N_REAL, 4 * N_REAL, scale, seed, "cpu")
    src = torch.cat([src, src[:20], torch.arange(5)])
    dst = torch.cat([dst, dst[:20], torch.full((5,), 10 ** 6)])
    n, e = _pad(N_REAL, NODE_PAD), _pad(src.numel(), EDGE_PAD)
    es = torch.full((e,), -1, dtype=torch.int32)
    ed = es.clone()
    es[:src.numel()] = src.int()
    ed[:dst.numel()] = dst.int()
    x = torch.randn(n, D_IN, generator=gen)
    x[N_REAL:] = 0
    mask = torch.zeros(n, dtype=torch.bool)
    mask[torch.randperm(N_REAL, generator=gen)[:N_REAL // 3]] = True
    return {"x": x, "edge_src": es, "edge_dst": ed, "label_mask": mask,
            "labels": torch.randint(0, N_CLASSES, (n,), generator=gen).int()}


def setup(seed: int, widths: str):
    batch = make_batch(seed)
    delta = ref.avg_log_degree(batch["edge_dst"], N_REAL)
    n_layers, d = WIDTHS[widths]
    cfg = pna.PNAConfig(n_layers=n_layers, d_hidden=d, d_in=D_IN,
                        n_classes=N_CLASSES, avg_log_degree=delta)
    params = pna_weights.pna_params(D_IN, d, N_CLASSES, n_layers, seed + 10,
                                    "cpu")
    return batch, delta, cfg, params


def grads(loss, params: dict) -> dict:
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    return dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                list(leaves.values()))))


def test_the_batches_hold_every_planted_case():
    batch = make_batch(1)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    n = batch["x"].shape[0]
    assert (src == -1).any() and ((dst == -1) == (src == -1)).all()
    assert (dst >= n).sum() == 5
    valid = (dst >= 0) & (dst < n)
    deg = torch.bincount(dst[valid], minlength=n)
    assert (deg[:N_REAL] == 0).any()          # real nodes with no in-edge
    pairs = torch.stack([src[valid], dst[valid]], 1)
    assert torch.unique(pairs, dim=0).shape[0] < pairs.shape[0]


@pytest.mark.parametrize("widths", sorted(WIDTHS))
@pytest.mark.parametrize("seed", SEEDS)
def test_forward_logits_and_loss_match_the_plain_reference(seed, widths):
    batch, delta, cfg, params = setup(seed, widths)
    g = ref.Graph(batch, delta)
    got, want = pna.forward(params, batch, cfg), ref.forward(params, g)
    assert got.shape == want.shape == (batch["x"].shape[0], N_CLASSES)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    lp, lr = float(pna.loss_fn(params, batch, cfg)), float(ref.loss(params, g))
    assert abs(lp - lr) <= 1e-6 * abs(lr)


@pytest.mark.parametrize("widths", sorted(WIDTHS))
@pytest.mark.parametrize("seed", SEEDS)
def test_gradients_match_the_plain_reference(seed, widths):
    batch, delta, cfg, params = setup(seed, widths)
    got = grads(lambda p: pna.loss_fn(p, batch, cfg), params)
    g32 = grads(lambda p: ref.loss(p, ref.Graph(batch, delta)), params)
    g64 = grads(lambda p: ref.loss(p, ref.Graph(batch, delta,
                                                torch.float64)),
                {k: v.double() for k, v in params.items()})
    top = max(float(g.abs().max()) for g in g64.values())
    slack = max(float((g32[k].double() - g64[k]).abs().max()) for k in g64)
    for k in params:
        leaf = float(g32[k].abs().max())
        assert float((got[k] - g32[k]).abs().max()) <= 2e-5 * leaf, k
        assert float((got[k].double() - g64[k]).abs().max()) <= \
            2 * slack + 1e-6 * top, k


@pytest.mark.parametrize("seed", SEEDS)
def test_three_adamw_steps_through_build_cell_match_the_reference(seed):
    batch, delta, cfg, params = setup(seed, "full")
    shape = GNNShape("plain_small", N_REAL, int((batch["edge_src"] >= 0).sum()),
                     D_IN, N_CLASSES)
    opt = AdamWConfig(**OPT)
    cell = build_cell("pna", shape, card_mesh(), opt_cfg=opt,
                      gnn_cfg_overrides={"avg_log_degree": delta})
    assert cell.shape_id == "plain_small" and cell.kind == "train"
    assert cell.cfg.avg_log_degree == delta and cell.cfg.d_hidden == 75
    assert {k: tuple(v.shape) for k, v in cell.args[1].items()} == \
        {k: tuple(v.shape) for k, v in batch.items()}
    state = {"params": {k: v.clone() for k, v in params.items()},
             "opt": adamw_init(params, opt)}
    losses = []
    for t in range(3):
        state, met = cell.fn(state, batch)
        losses.append(float(met["loss"]))
        if t == 0:
            first = {k: m / (1 - opt.b1) for k, m in state["opt"]["m"].items()}
    prog = {"losses": losses, "first_grad": first, "params": state["params"]}
    r = ref_gcn.readings(prog, ref.train(params, batch, OPT, delta, 3), params)
    assert r["loss_gap"] <= 1e-6
    assert r["grad_gap"] <= 1e-5
    assert r["change_gap"] <= 1e-4


def test_an_unchanged_state_fails_the_step_readings():
    """The readings the step is held to can fail: a state left as it
    was reads a change gap of 1."""
    batch, delta, _, params = setup(1, "full")
    want = ref.train(params, batch, OPT, delta, 3)
    same = {"losses": want["losses"], "first_grad": want["first_grad"],
            "params": params}
    assert ref_gcn.readings(same, want, params)["change_gap"] == \
        pytest.approx(1.0)


def test_cell_flops_are_the_port_formula():
    from perfbench.gen import pna_arith
    shape = GNNShape("ogbn_arxiv", 169343, 2332486, 128, 40)
    cell = build_cell("pna", shape, card_mesh(),
                      gnn_cfg_overrides={"avg_log_degree": 2.0})
    assert cell.model_flops == pna_arith.pna_step_flops(
        169343, 2332486, 128, 75, 4) == pytest.approx(9.367e11, rel=1e-3)
    n, e = cell.args[1]["x"].shape[0], cell.args[1]["edge_src"].shape[0]
    assert (n, e) == (_pad(169343, NODE_PAD), _pad(2332486, EDGE_PAD))


def test_the_catalog_is_unchanged():
    want = {"full_graph_sm": (2708, 10556, 1433, 7, 1),
            "minibatch_lg": (1024 + 1024 * 15 + 1024 * 150,
                             1024 * 15 + 1024 * 150, 602, 41, 1),
            "ogb_products": (2449029, 61859140, 100, 47, 1),
            "molecule": (128 * 30, 128 * 64, 16, 16, 128)}
    build_cell("pna", GNNShape("elsewhere", 1000, 4000, 8, 3), card_mesh())
    have = {k: (s.n_nodes, s.n_edges, s.d_feat, s.n_classes, s.n_graphs)
            for k, s in GNN_SHAPES.items()}
    assert have == want
    cells = all_cells()
    assert len(cells) == 40 and len(set(cells)) == 40
    assert all(s in GNN_SHAPES for a, s in cells
               if a in ("gcn-cora", "pna", "dimenet", "meshgraphnet"))


def test_a_gnn_shape_does_not_size_another_family():
    with pytest.raises(TypeError):
        build_cell("smollm-360m", GNNShape("g", 10, 10, 4, 2), card_mesh())


def _ranges(prof) -> dict:
    out: dict = {}
    for ev in prof.events():
        if ev.name.startswith("pna."):
            out[ev.name] = out.get(ev.name, 0) + 1
    return out


@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_pna_phases_are_profiler_ranges_with_the_same_bits(widths):
    batch, _, cfg, params = setup(2, widths)
    plain = pna.forward(params, batch, cfg)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = pna.forward(params, batch, cfg)
    assert torch.equal(plain, traced)
    n = cfg.n_layers
    assert _ranges(prof) == {"pna.encode": 1, "pna.message": n,
                             "pna.aggregate": n, "pna.update": n,
                             "pna.head": 1}


def test_no_range_opens_without_a_profiler(monkeypatch):
    from torch.autograd import profiler
    from repro_torch.obs.trace import profiler_range

    opened = []
    real = profiler.record_function
    monkeypatch.setattr(profiler, "record_function",
                        lambda name, *a: opened.append(name) or real(name))
    batch, _, cfg, params = setup(3, "reduced")
    pna.forward(params, batch, cfg)
    with profiler_range("pna.test") as r:
        assert r._range is None
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler_range("pna.test") as r:
            assert r._range is not None
    assert opened == ["pna.test"]
