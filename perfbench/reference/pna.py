"""The plain reference of the PNA training cell.

PNA, Principal Neighbourhood Aggregation (Corso et al.,
arXiv:2004.05718), trained by AdamW, written out in plain torch from the
paper's equations and never from the program under test.  A layer of
width ``d`` over the edges ``j -> i``:

* message ``m_ij = relu([h_j, h_i] W_msg + b_msg)`` (eq. 8's M);
* aggregators over each node's in-edges (eq. 4): mean and std by
  ``index_add_`` sums, ``std = sqrt(max(E[m^2] - E[m]^2, 0) + 1e-5)``;
  max and min by ``scatter_reduce`` ("amax" / "amin",
  ``include_self=False``);
* scalers (eq. 5) on the in-degree ``d_i``: identity,
  amplification ``log(d_i + 1) / delta`` and attenuation
  ``delta / log(d_i + 1)``, ``delta`` the mean of ``log(d + 1)`` over
  the training graph;
* update ``h_i' = h_i + relu([h_i, the 12 scaled views] W_tower +
  b_tower)`` (eq. 8's U, with the residual).

A linear encoder comes first and a linear head last; the loss is the
masked mean cross-entropy.  Departures from the paper, each also in the
configuration's ``assumed``:

* one tower, and M and U a single linear layer with ReLU each;
* no batch norm; no edge features;
* the attenuation clamps ``log(d + 1)`` at 1e-2 (a node with no
  in-edge);
* std as written above (the 1e-5 inside the root);
* an empty segment's mean, max and min are 0 (so its std is
  ``sqrt(1e-5)``);
* tied maxima (minima) share the gradient evenly;
* an edge with an end outside ``[0, N)`` is no edge (the cell pads both
  ends with -1).

:func:`train` follows the benchmark's documented step (the loss, its
gradients by autograd, then AdamW with global-norm clipping,
bias-corrected moments, decoupled weight decay on every leaf and a
linear warm-up then a cosine) from the benchmark's own initial weights
and inputs (``perfbench/gen``).  Float32 with TF32 off, or float64
throughout; a control runs it with its dense products in TF32 (on the
card) or bfloat16.  Imports torch alone.
"""

from __future__ import annotations

import math

import torch

#: the aggregators and scalers in the order the update concatenates
#: their views: (mean, max, min, std) x (identity, amplification,
#: attenuation)
AGGREGATORS = ("mean", "max", "min", "std")


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


def avg_log_degree(edge_dst: torch.Tensor, n_nodes: int) -> float:
    """``delta``: the mean of ``log(d + 1)`` over the ``n_nodes`` real
    nodes, ``d`` each node's in-degree over the valid edges (float64)."""
    dst = edge_dst.long()
    dst = dst[(dst >= 0) & (dst < n_nodes)]
    deg = torch.bincount(dst, minlength=n_nodes).double()
    return float(torch.log1p(deg).mean())


class Graph:
    """One batch's valid edges, in-degrees, scalers and masked labels,
    worked out from the batch alone, in ``dtype``."""

    def __init__(self, batch: dict, delta: float, dtype=torch.float32):
        src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
        self.x = batch["x"].to(dtype)
        n = self.n = self.x.shape[0]
        keep = (src >= 0) & (dst >= 0) & (src < n) & (dst < n)
        self.src, self.dst = src[keep], dst[keep]
        deg = torch.bincount(self.dst, minlength=n).to(dtype)
        self.count = deg.clamp(min=1)[:, None]
        logd = torch.log(deg + 1)
        self.amp = (logd / delta)[:, None]
        self.att = (delta / logd.clamp(min=1e-2))[:, None]
        mask = batch["label_mask"]
        self.labels = torch.where(mask, batch["labels"].long(), -100)

    def sum(self, m: torch.Tensor) -> torch.Tensor:
        return torch.zeros((self.n, m.shape[1]), dtype=m.dtype,
                           device=m.device).index_add(0, self.dst, m)

    def extreme(self, m: torch.Tensor, how: str) -> torch.Tensor:
        """Per-node max ("amax") or min ("amin") of ``m``; an empty
        segment keeps the initial 0."""
        idx = self.dst[:, None].expand(-1, m.shape[1])
        return torch.zeros((self.n, m.shape[1]), dtype=m.dtype,
                           device=m.device).scatter_reduce(
            0, idx, m, how, include_self=False)


def forward(params: dict, g: Graph, mm_dtype=None) -> torch.Tensor:
    """Logits of every node; the dense products in ``mm_dtype`` (a
    control's lower precision; None: the graph's dtype), everything else
    in the graph's dtype."""
    dtype = g.x.dtype
    mm_dtype = mm_dtype or dtype
    mm = lambda a, w: (a.to(mm_dtype) @ w.to(mm_dtype)).to(dtype)
    p = {k: v.to(dtype) for k, v in params.items()}
    h = mm(g.x, p["enc_w"]) + p["enc_b"]
    n_layers = sum(1 for k in p if k.startswith("msg_w"))
    for i in range(n_layers):
        m = torch.relu(mm(torch.cat([h[g.src], h[g.dst]], dim=-1),
                          p[f"msg_w{i}"]) + p[f"msg_b{i}"])
        mean = g.sum(m) / g.count
        mean2 = g.sum(m * m) / g.count
        var = mean2 - mean * mean
        std = torch.sqrt(torch.maximum(var, torch.zeros_like(var)) + 1e-5)
        aggs = {"mean": mean, "max": g.extreme(m, "amax"),
                "min": g.extreme(m, "amin"), "std": std}
        views = []
        for a in AGGREGATORS:
            views += [aggs[a], aggs[a] * g.amp, aggs[a] * g.att]
        h = h + torch.relu(mm(torch.cat([h] + views, dim=-1),
                              p[f"tower_w{i}"]) + p[f"tower_b{i}"])
    return mm(h, p["head_w"]) + p["head_b"]


def loss(params: dict, g: Graph, mm_dtype=None) -> torch.Tensor:
    """The masked mean cross-entropy over the labelled nodes."""
    return torch.nn.functional.cross_entropy(forward(params, g, mm_dtype),
                                             g.labels, ignore_index=-100)


def train(params0: dict, batch: dict, opt: dict, delta: float,
          steps: int = 3, precision: str = "float32") -> dict:
    """``steps`` AdamW steps from ``params0``: the losses, the first
    gradient as the optimizer takes it (after clipping) and the
    parameters after the last step.  ``precision``: "float32" (TF32
    off), "float64" (everything, the optimizer too), or "tf32" /
    "bfloat16": the dense products (forward and backward) in that lower
    precision, the rest float32 -- the controls."""
    prev = _tf32(precision == "tf32")
    dtype = torch.float64 if precision == "float64" else torch.float32
    mm_dtype = torch.bfloat16 if precision == "bfloat16" else None
    try:
        g = Graph(batch, delta, dtype)
        p = {k: v.detach().to(dtype).clone() for k, v in params0.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        losses, first_grad = [], None
        for t in range(1, steps + 1):
            leaves = {k: x.clone().requires_grad_() for k, x in p.items()}
            with torch.enable_grad():
                lval = loss(leaves, g, mm_dtype)
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
            del leaves, grads, lval
        return {"losses": losses, "first_grad": first_grad, "params": p}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
