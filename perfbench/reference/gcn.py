"""The plain reference of the GCN training cell.

A 2-layer GCN (arXiv:1609.02907, symmetric normalisation with self
loops) trained by AdamW, written out in plain torch: gathers by
indexing, sums by ``index_add_``, gradients by autograd.  It follows the
port's documented step (``launch/steps.py``: loss, gradients, then
``optim/adamw.py``'s update: global-norm clipping, bias-corrected
moments, decoupled weight decay on every leaf, linear warm-up then a
cosine) from the benchmark's own initial weights and inputs
(``perfbench/gen``), and never reads what the program made.  Float32 with TF32 off; a control runs it
with its dense products in TF32 (on the card) or bfloat16.

Layer 0's aggregation needs no gradient (the features are inputs), so
it is summed once, in blocks of edges, to bound memory at ogbn-products'
size.

:func:`readings` turns the program's and the reference's first steps
into the numbers the cell compares: each step's loss gap, and by the
worst leaf the gaps of the first gradient's norm and of the 3-step
parameter change's norm, each against the larger of that leaf's
reference norm and the median leaf's.  Imports torch alone.
"""

from __future__ import annotations

import math
import statistics

import torch

EDGE_BLOCK = 1 << 23


def _tf32(on: bool) -> tuple:
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    return prev


def _schedule(opt: dict, step: int) -> float:
    lr, warm, total = opt["lr"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return lr * step / max(1, warm)
    t = min(max((step - warm) / max(1, total - warm), 0.0), 1.0)
    return (opt["min_lr_frac"] * lr
            + (1 - opt["min_lr_frac"]) * lr * 0.5 * (1 + math.cos(math.pi * t)))


class Graph:
    """The valid edges, the normalisation and the layer-0 aggregation of
    one batch, worked out from the batch alone."""

    def __init__(self, batch: dict):
        src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
        x = batch["x"].float()
        n = x.shape[0]
        keep = (src >= 0) & (dst >= 0) & (src < n) & (dst < n)
        self.src, self.dst = src[keep], dst[keep]
        deg = torch.bincount(self.dst, minlength=n).float() + 1.0
        dn = torch.rsqrt(deg)
        self.w = dn[self.src] * dn[self.dst]
        self.self_w = 1.0 / deg
        self.n = n
        agg = torch.zeros_like(x)
        for a in range(0, self.src.numel(), EDGE_BLOCK):
            s, d = self.src[a:a + EDGE_BLOCK], self.dst[a:a + EDGE_BLOCK]
            agg.index_add_(0, d, x[s] * self.w[a:a + EDGE_BLOCK, None])
        self.agg0 = agg + x * self.self_w[:, None]
        mask = batch["label_mask"]
        self.labels = torch.where(mask, batch["labels"].long(), -100)


def loss(params: dict, g: Graph, dtype=torch.float32) -> torch.Tensor:
    """The masked mean cross-entropy; the two dense products in
    ``dtype`` (a control's lower precision), everything else float32."""
    mm = lambda a, w: (a.to(dtype) @ w.to(dtype)).float()
    h = torch.relu(mm(g.agg0, params["w0"]) + params["b0"])
    msgs = h[g.src] * g.w[:, None]
    agg = torch.zeros_like(h).index_add(0, g.dst, msgs) + h * g.self_w[:, None]
    logits = mm(agg, params["w1"]) + params["b1"]
    return torch.nn.functional.cross_entropy(logits, g.labels,
                                             ignore_index=-100)


def train(params0: dict, batch: dict, opt: dict, steps: int = 3,
          precision: str = "float32") -> dict:
    """``steps`` AdamW steps from ``params0``: the losses, the first
    gradient as the optimizer takes it (after clipping) and the
    parameters after the last step.  ``precision`` "tf32" or "bfloat16"
    computes the dense products (forward and backward) in that lower
    precision: the controls."""
    prev = _tf32(precision == "tf32")
    dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
    try:
        g = Graph(batch)
        p = {k: v.detach().float().clone() for k, v in params0.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        losses, first_grad = [], None
        for t in range(1, steps + 1):
            leaves = {k: x.clone().requires_grad_() for k, x in p.items()}
            with torch.enable_grad():
                lval = loss(leaves, g, dtype)
                grads = dict(zip(leaves, torch.autograd.grad(
                    lval, list(leaves.values()))))
            losses.append(float(lval.detach()))
            gnorm = torch.sqrt(sum(torch.sum(gr * gr) for gr in grads.values()))
            scale = min(opt["clip_norm"] / max(float(gnorm), 1e-9), 1.0)
            lr = _schedule(opt, t)
            b1c = 1 - opt["b1"] ** t
            b2c = 1 - opt["b2"] ** t
            for k in p:
                gk = grads[k] * scale
                m[k] = opt["b1"] * m[k] + (1 - opt["b1"]) * gk
                v2[k] = opt["b2"] * v2[k] + (1 - opt["b2"]) * gk * gk
                step = (m[k] / b1c) / (torch.sqrt(v2[k] / b2c) + opt["eps"])
                p[k] = p[k] - lr * (step + opt["weight_decay"] * p[k])
            if t == 1:
                first_grad = {k: grads[k] * scale for k in p}
        return {"losses": losses, "first_grad": first_grad, "params": p}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _worst_leaf_gap(got: dict, want: dict) -> float:
    norms = {k: float(torch.linalg.vector_norm(want[k].float()))
             for k in want}
    med = statistics.median(norms.values())
    gaps = []
    for k in want:
        g = float(torch.linalg.vector_norm(got[k].float()))
        gaps.append(abs(g - norms[k]) / max(norms[k], med, 1e-30))
    return max(gaps)


def readings(prog: dict, ref: dict, params0: dict) -> dict:
    """The compared numbers: ``loss_gap`` (largest relative gap of a
    step's loss), ``grad_gap`` (the first gradient's norms, worst leaf)
    and ``change_gap`` (the parameters' change over the steps, worst
    leaf).  ``prog`` and ``ref`` are shaped as :func:`train` returns;
    leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of the change (round-off alone moves them under
    Adam)."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    grad_gap = _worst_leaf_gap(prog["first_grad"], ref["first_grad"])
    gn = {k: float(torch.linalg.vector_norm(v))
          for k, v in ref["first_grad"].items()}
    med = statistics.median(gn.values())
    moved = [k for k in gn if gn[k] >= 1e-3 * med]
    change = lambda res: {k: res["params"][k].float() - params0[k].float()
                          for k in moved}
    change_gap = _worst_leaf_gap(change(prog), change(ref))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}
