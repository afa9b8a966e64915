"""Full-graph PNA training through the port's cell path (``train_pna``
mixes).

The GCN driver's cell (``drivers/train.py``) on another model: set-up
draws the graph, features, labels and training mask with
``train.make_batch`` on the input specs of a ``GNNShape`` of the
configuration's own sizes (``configs/shapes.py::gnn_input_specs``: a
dataset outside the port's catalog), works out the degree constant
``delta`` from the drawn graph, and builds the step the port builds for
that shape (``build_cell("pna", shape, card_mesh(),
gnn_cfg_overrides={"avg_log_degree": delta})``).  The initial weights
come from ``perfbench/gen/pna_weights.py``.  The first ``checked_steps``
steps are recorded, the window continues from their state with steps
back to back closed by a synchronize, and after the window the plain
reference (``perfbench/reference/pna.py``) follows the same steps from
the same initial weights; the numbers compared are the GCN cell's
(``reference/gcn.py::readings``).
"""

from __future__ import annotations

import sys
import time

import torch

from perfbench.drivers import train
from perfbench.gen import pna_arith, pna_weights
from perfbench.reference import gcn as ref_gcn
from perfbench.reference import pna as ref_pna

#: the limits of the compared numbers, each between the largest reading
#: of sound runs and the smallest of the TF32 control or the half-batch
#: fault on the card (near their geometric mean: sound runs read up to
#: 6.6e-6 / 4.4e-5 on 19 seeds, the TF32 control from 1.8e-4 / 5.0e-4
#: on 11); PERF.md gives the readings.  The loss gap is printed, not compared, as in the
#: GCN cell
LIMITS = {"grad_gap": 4e-5, "change_gap": 1.5e-4}
#: the precision the reference runs in for the comparison
REFERENCE_PRECISION = "float32"


class Cell(train.Cell):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 trace: bool):
        from repro_torch.configs.shapes import GNNShape, gnn_input_specs
        from repro_torch.launch.mesh import card_mesh
        from repro_torch.launch.steps import build_cell
        from repro_torch.optim.adamw import AdamWConfig, adamw_init

        # the configuration states float32 with TF32 off
        torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
        torch.backends.cudnn.allow_tf32 = cfg["tf32"]
        self.cfg, self.device = cfg, device
        shape = GNNShape(cfg["shape_name"], cfg["n_nodes"], cfg["n_edges"],
                         cfg["d_in"], cfg["n_classes"])
        t0 = time.perf_counter()
        self.batch = train.make_batch(cfg, gnn_input_specs(shape, cfg["arch"]),
                                      seed, device)
        self.delta = ref_pna.avg_log_degree(self.batch["edge_dst"],
                                            cfg["n_nodes"])
        print(f"setup: inputs in {time.perf_counter() - t0:.3f} s, delta "
              f"{self.delta!r}", file=sys.stderr)
        opt = AdamWConfig(**cfg["optimizer"])
        t0 = time.perf_counter()
        cell = build_cell(cfg["arch"], shape, card_mesh(), opt_cfg=opt,
                          gnn_cfg_overrides={"avg_log_degree": self.delta})
        print(f"setup: build_cell in {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)
        mcfg = cell.cfg
        for key, want in (("n_layers", cfg["n_layers"]),
                          ("d_hidden", cfg["d_hidden"]),
                          ("d_in", cfg["d_in"]),
                          ("n_classes", cfg["n_classes"]),
                          ("dtype", cfg["dtype"]),
                          ("avg_log_degree", self.delta)):
            have = getattr(mcfg, key)
            if key == "dtype":
                have = str(have).removeprefix("torch.")
            if have != want:
                raise ValueError(f"the port's {cfg['arch']} cell has {key} "
                                 f"{have}, the benchmark {want}")
        train._fits(self.batch, cell.args[1])
        self.step = cell.fn
        params = pna_weights.pna_params(
            cfg["d_in"], cfg["d_hidden"], cfg["n_classes"], cfg["n_layers"],
            int(seed) + 2, device, dtype=getattr(torch, cfg["dtype"]))
        train._fits(params, cell.args[0]["params"])
        self.params0 = {k: v.detach().clone() for k, v in params.items()}
        self.state = {"params": params, "opt": adamw_init(params, opt)}
        self.attempted = self.failed = 0
        steps = int(traffic["checked_steps"])
        losses = []
        t0 = time.perf_counter()
        for t in range(steps):
            self.state, met = self.step(self.state, self.batch)
            losses.append(float(met["loss"]))
            if t == 0:
                self.first_grad = {k: m.detach() / (1 - opt.b1) for k, m in
                                   self.state["opt"]["m"].items()}
        print(f"setup: {steps} first steps in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
        self.prog = {"losses": losses, "first_grad": self.first_grad,
                     "params": {k: v.detach().clone() for k, v in
                                self.state["params"].items()}}
        self.steps = steps
        self.opt = dict(cfg["optimizer"])
        self._ref = None

    def _train_reference(self, batch: dict, precision: str) -> dict:
        return ref_pna.train(self.params0, batch, self.opt, self.delta,
                             self.steps, precision=precision)

    def _reference(self) -> dict:
        if self._ref is None:
            self._ref = self._train_reference(self.batch,
                                              REFERENCE_PRECISION)
        return self._ref

    def _checks(self, side: dict) -> dict:
        r = ref_gcn.readings(side, self._reference(), self.params0)
        print(f"reading loss_gap (not compared): {r['loss_gap']!r}",
              file=sys.stderr)
        return {k: (r[k], lim) for k, lim in LIMITS.items()}

    def control(self) -> dict:
        """The control's and a fault's numbers, as :meth:`check` gives
        the program's: the reference with its dense products in TF32
        (bfloat16 off the card, which has no TF32), and the reference on
        half of the batch, every other labelled node left out."""
        lower = "tf32" if torch.device(self.device).type == "cuda" \
            else "bfloat16"
        ctrl = self._train_reference(self.batch, lower)
        mask = self.batch["label_mask"].clone()
        mask[torch.nonzero(mask).flatten()[1::2]] = False
        half = self._train_reference(dict(self.batch, label_mask=mask),
                                     "float32")
        return {f"reference_in_{lower}": self._checks(ctrl),
                "half_batch": self._checks(half)}

    def context(self) -> dict:
        cfg = self.cfg
        dst = self.batch["edge_dst"]
        return {"steps": self.attempted,
                "step_s": self.window_s / self.attempted,
                "flops": pna_arith.pna_step_flops(
                    cfg["n_nodes"], cfg["n_edges"], cfg["d_in"],
                    cfg["d_hidden"], cfg["n_layers"]),
                "e_slots": dst.numel(), "n_slots": self.batch["x"].shape[0],
                "valid_edges": int((dst >= 0).sum()),
                "grad_rows": int(torch.unique(dst[dst >= 0]).numel()),
                "d_hidden": cfg["d_hidden"], "n_layers": cfg["n_layers"]}
