"""GCN [Kipf & Welling, arXiv:1609.02907] — gcn-cora config:
n_layers=2, d_hidden=16, mean/sym-normalized aggregation.

SpMM regime:  H' = sigma( D^-1/2 (A+I) D^-1/2 H W )  realized as
gather(src) -> per-edge scale -> segment-sum -> dense W (one pass on the
card where H needs no gradient: ``layers.weighted_scatter_sum``).

The parameters are a plain dict with the JAX package's keys ``w0, b0,
w1, b1, ...`` (:func:`repro_torch.convert.gcn_params_from_numpy` carries
the reference's weights over).  Float32 throughout; the dense products
run in IEEE float32 (TF32 is never turned on here).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import cross_entropy_loss, dense_init
from repro_torch.models.gnn import layers as L


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_hidden: int = 16
    d_in: int = 1433
    n_classes: int = 7
    norm: str = "sym"       # "sym" | "mean"
    dtype: torch.dtype = torch.float32
    # A(XW) instead of (AX)W when d_out < d_in: same math (both are
    # linear), but the gathered/scattered messages shrink from d_in-wide
    # to d_out-wide.
    transform_first: bool = False


def init_params(cfg: GCNConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights from ``generator`` (truncated-normal fan-in), zero
    biases."""
    params = {}
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    for i in range(cfg.n_layers):
        params[f"w{i}"] = dense_init(generator, (dims[i], dims[i + 1]),
                                     dtype=cfg.dtype, device=device)
        params[f"b{i}"] = torch.zeros(dims[i + 1], dtype=cfg.dtype,
                                      device=device)
    return params


def forward(params: dict, batch: dict, cfg: GCNConfig) -> torch.Tensor:
    x = batch["x"].to(cfg.dtype)
    src, dst = batch["edge_src"], batch["edge_dst"]
    n = x.shape[0]
    deg = L.degree(dst, n) + 1.0  # +1: self loop
    if cfg.norm == "sym":
        dn = torch.rsqrt(deg)
        w_edge = L.gather(dn[:, None], src)[:, 0] * L.gather(dn[:, None], dst)[:, 0]
        self_w = 1.0 / deg
    else:
        w_edge = 1.0 / L.gather(deg[:, None], dst)[:, 0].clamp(min=1)
        self_w = 1.0 / deg
    for i in range(cfg.n_layers):
        if cfg.transform_first and params[f"w{i}"].shape[1] < x.shape[1]:
            x = x @ params[f"w{i}"]
            x = (L.weighted_scatter_sum(x, src, w_edge, dst, n)
                 + x * self_w[:, None] + params[f"b{i}"])
        else:
            agg = (L.weighted_scatter_sum(x, src, w_edge, dst, n)
                   + x * self_w[:, None])
            x = agg @ params[f"w{i}"] + params[f"b{i}"]
        if i < cfg.n_layers - 1:
            x = torch.relu(x)
    return x


def loss_fn(params: dict, batch: dict, cfg: GCNConfig) -> torch.Tensor:
    logits = forward(params, batch, cfg)
    labels = torch.where(batch["label_mask"], batch["labels"], -100)
    return cross_entropy_loss(logits, labels)
