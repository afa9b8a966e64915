"""Full-graph GCN training through the port's cell path (``train``
mixes).

Set-up builds the step the port builds for the cell
(``repro_torch.launch.steps.build_cell(arch, shape, card_mesh())``),
draws the graph, features, labels, training mask and initial weights
(``perfbench/gen/weights.py``) on the device from the seed, hands the
weights to the program's state, and drives that one state through the first
``checked_steps`` steps of the window's own call on the same batch,
recording each step's loss, the gradient the optimizer took at the first
(its first moment after one step, over ``1 - b1``) and the parameters
after the last.  The window continues from that state: steps back to
back, closed by a synchronize.  After the window the plain reference
(``perfbench/reference/gcn.py``) follows the same steps from the same
initial weights.
"""

from __future__ import annotations

import sys
import time

import torch

from perfbench.gen import arith, kronecker, weights
from perfbench.reference import gcn as ref_gcn

#: the limits of the compared numbers, each between the largest reading
#: of sound runs (lower) and the smallest of the TF32 control or a
#: planted fault (upper) on the card; PERF.md gives the readings.  The
#: loss gap is read and printed but not compared: sound runs read 0 to
#: 3 ulps of the loss, the TF32 control as little, and half the batch
#: left out under ten times that on some seeds, so it has no upper
#: reading
LIMITS = {"grad_gap": 3e-6, "change_gap": 5e-6}


def make_batch(cfg: dict, specs: dict, seed: int, device) -> dict:
    """The cell's batch on ``device``: the graph, ``n_edges / 2``
    undirected Kronecker edges over the real nodes drawn from the
    configuration's own seed, each written in both directions, its
    inverse right after it (OGB's ``add_inverse_edge``), pad slots -1;
    and from ``seed`` N(0, 1) features (pad rows 0), labels uniform over
    the classes and ``train_nodes`` real nodes in the mask.  The graph is
    the dataset and the same in every run: its labelling sets where the
    gathers and K2's atomics land, and so the step's time."""
    n, e = cfg["n_nodes"], cfg["n_edges"]
    if e > specs["edge_src"].shape[0] or n > specs["x"].shape[0]:
        raise ValueError(f"the cell's inputs hold fewer than {n} nodes and "
                         f"{e} edges")
    if e % 2:
        raise ValueError(f"{e} directed edges are not undirected ones "
                         f"written both ways")
    src, dst = kronecker.bounded_edges(n, e // 2, cfg["edges"]["scale"],
                                       cfg["edges"]["seed"], device)
    gen = kronecker.generator(int(seed) + 1, device)
    batch = {}
    for key, (a, b) in (("edge_src", (src, dst)), ("edge_dst", (dst, src))):
        ids = torch.full(tuple(specs[key].shape), -1, dtype=specs[key].dtype,
                         device=device)
        ids[0:e:2] = a.to(specs[key].dtype)
        ids[1:e:2] = b.to(specs[key].dtype)
        batch[key] = ids
    del src, dst
    n_pad, d = specs["x"].shape
    x = torch.randn((n_pad, d), generator=gen, device=device)
    x[n:] = 0.0
    batch["x"] = x
    batch["labels"] = torch.randint(0, cfg["n_classes"], (n_pad,),
                                    generator=gen, device=device
                                    ).to(specs["labels"].dtype)
    mask = torch.zeros(n_pad, dtype=torch.bool, device=device)
    mask[torch.randperm(n, generator=gen, device=device)
         [:cfg["train_nodes"]]] = True
    batch["label_mask"] = mask
    return batch


def _fits(params: dict, specs: dict) -> None:
    """Raise unless ``params`` has the leaves, shapes and dtypes of the
    cell's parameter ``specs``."""
    have = {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
    want = {k: (tuple(v.shape), v.dtype) for k, v in specs.items()}
    if have != want:
        raise ValueError(f"the benchmark's weights {have} do not fit the "
                         f"cell's parameters {want}")


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 trace: bool):
        from repro_torch.launch.mesh import card_mesh
        from repro_torch.launch.steps import build_cell
        from repro_torch.optim.adamw import AdamWConfig, adamw_init

        # the configuration states float32 with TF32 off
        torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
        torch.backends.cudnn.allow_tf32 = cfg["tf32"]
        self.cfg, self.device = cfg, device
        opt = AdamWConfig(**cfg["optimizer"])
        t0 = time.perf_counter()
        cell = build_cell(cfg["arch"], cfg["shape"], card_mesh(), opt_cfg=opt)
        print(f"setup: build_cell in {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)
        mcfg = cell.cfg
        for key in ("n_layers", "d_hidden", "d_in", "n_classes", "norm",
                    "dtype"):
            have = getattr(mcfg, key)
            if key == "dtype":
                have = str(have).removeprefix("torch.")
            if have != cfg[key]:
                raise ValueError(f"the port's {cfg['arch']} cell has {key} "
                                 f"{have}, the configuration {cfg[key]}")
        self.step = cell.fn
        t0 = time.perf_counter()
        self.batch = make_batch(cfg, cell.args[1], seed, device)
        params = weights.gcn_params(cfg["d_in"], cfg["d_hidden"],
                                    cfg["n_classes"], int(seed) + 2, device,
                                    dtype=getattr(torch, cfg["dtype"]))
        _fits(params, cell.args[0]["params"])
        self.params0 = {k: v.detach().clone() for k, v in params.items()}
        self.state = {"params": params, "opt": adamw_init(params, opt)}
        self.attempted = self.failed = 0
        steps = int(traffic["checked_steps"])
        losses = []
        for t in range(steps):
            self.state, met = self.step(self.state, self.batch)
            losses.append(float(met["loss"]))
            if t == 0:
                self.first_grad = {k: m.detach() / (1 - opt.b1) for k, m in
                                   self.state["opt"]["m"].items()}
        print(f"setup: inputs and {steps} first steps in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
        self.prog = {"losses": losses, "first_grad": self.first_grad,
                     "params": {k: v.detach().clone() for k, v in
                                self.state["params"].items()}}
        self.steps = steps
        self.opt = dict(cfg["optimizer"])
        self._ref = None

    def run(self, seconds: float) -> dict:
        n = 0
        losses = []
        t0 = time.perf_counter()
        while True:
            self.state, met = self.step(self.state, self.batch)
            losses.append(met["loss"])
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - t0
        self.attempted = n
        self.failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"gcn_step_ms": self.window_s / n * 1e3}

    def release(self) -> None:
        del self.state
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self) -> dict:
        if self._ref is None:
            self._ref = ref_gcn.train(self.params0, self.batch, self.opt,
                                      self.steps)
        return self._ref

    def _checks(self, side: dict) -> dict:
        r = ref_gcn.readings(side, self._reference(), self.params0)
        print(f"reading loss_gap (not compared): {r['loss_gap']!r}",
              file=sys.stderr)
        return {k: (r[k], lim) for k, lim in LIMITS.items()}

    def check(self) -> dict:
        out = self._checks(self.prog)
        out["steps_not_finite"] = (self.failed, 0)
        return out

    def control(self) -> dict:
        """The control's and a fault's numbers, as :meth:`check` gives
        the program's: the reference with its dense products in TF32
        (bfloat16 off the card, which has no TF32), and the reference on
        half of the batch, every other labelled node left out and the
        mean taken over the rest."""
        lower = "tf32" if torch.device(self.device).type == "cuda" \
            else "bfloat16"
        ctrl = ref_gcn.train(self.params0, self.batch, self.opt, self.steps,
                             precision=lower)
        mask = self.batch["label_mask"].clone()
        mask[torch.nonzero(mask).flatten()[1::2]] = False
        half = ref_gcn.train(self.params0, dict(self.batch, label_mask=mask),
                             self.opt, self.steps)
        return {f"reference_in_{lower}": self._checks(ctrl),
                "half_batch": self._checks(half)}

    def context(self) -> dict:
        cfg = self.cfg
        valid = int((self.batch["edge_dst"] >= 0).sum())
        rows = int(torch.unique(self.batch["edge_dst"][
            self.batch["edge_dst"] >= 0]).numel())
        return {"steps": self.attempted,
                "step_s": self.window_s / self.attempted,
                "flops": arith.gcn_step_flops(
                    cfg["n_nodes"], cfg["n_edges"], cfg["d_in"],
                    cfg["d_hidden"], cfg["n_classes"]),
                "n_nodes": cfg["n_nodes"], "n_edges": cfg["n_edges"],
                "e_slots": self.batch["edge_dst"].numel(),
                "n_slots": self.batch["x"].shape[0],
                "valid_edges": valid, "grad_rows": rows,
                "d_in": cfg["d_in"], "d_hidden": cfg["d_hidden"]}

    def close(self) -> None:
        pass
