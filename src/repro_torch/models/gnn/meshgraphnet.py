"""MeshGraphNet [arXiv:2010.03409] — learned mesh-based simulation.

Config: n_layers=15, d_hidden=128, sum aggregation, 2-layer MLPs.
Encode-Process-Decode: node/edge encoders, 15 graph-net blocks with
residual edge+node updates, node decoder predicting dynamics targets.

The parameters are the JAX package's nested dict: ``node_enc``,
``edge_enc``, ``decoder`` and ``edge_mlp{i}`` / ``node_mlp{i}``, each
holding ``l0_w, l0_b, l1_w, ...`` (:func:`repro_torch.models.common.mlp`).
Every aggregation goes through the segment-sum kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import init_mlp, mlp
from repro_torch.models.gnn import layers as L


@dataclasses.dataclass(frozen=True)
class MeshGraphNetConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 16
    d_edge_in: int = 8
    d_out: int = 3            # e.g. acceleration / velocity targets
    dtype: torch.dtype = torch.float32


def _mlp_sizes(cfg: MeshGraphNetConfig, d_in: int, d_out: int) -> list[int]:
    return [d_in] + [cfg.d_hidden] * (cfg.mlp_layers - 1) + [d_out]


def _names(cfg: MeshGraphNetConfig) -> list[str]:
    return [f"l{i}" for i in range(cfg.mlp_layers)]


def init_params(cfg: MeshGraphNetConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights from ``generator`` (truncated-normal fan-in), zero
    biases."""
    names, d = _names(cfg), cfg.d_hidden

    def block(d_in, d_out):
        return init_mlp(generator, _mlp_sizes(cfg, d_in, d_out), names,
                        cfg.dtype, device)

    p = {"node_enc": block(cfg.d_node_in, d),
         "edge_enc": block(cfg.d_edge_in, d),
         "decoder": block(d, cfg.d_out)}
    for i in range(cfg.n_layers):
        p[f"edge_mlp{i}"] = block(3 * d, d)
        p[f"node_mlp{i}"] = block(2 * d, d)
    return p


def forward(params: dict, batch: dict, cfg: MeshGraphNetConfig
            ) -> torch.Tensor:
    names = _names(cfg)
    x = batch["x"].to(cfg.dtype)
    e = batch["edge_attr"].to(cfg.dtype)
    src, dst = batch["edge_src"], batch["edge_dst"]
    n = x.shape[0]

    h = mlp(params["node_enc"], x, names)
    he = mlp(params["edge_enc"], e, names)
    for i in range(cfg.n_layers):
        cat = torch.cat([he, L.gather(h, src), L.gather(h, dst)], dim=-1)
        he = he + mlp(params[f"edge_mlp{i}"], cat, names)
        agg = L.scatter_sum(he, dst, n)                    # sum aggregator
        h = h + mlp(params[f"node_mlp{i}"], torch.cat([h, agg], dim=-1),
                    names)
    return mlp(params["decoder"], h, names)


def loss_fn(params: dict, batch: dict, cfg: MeshGraphNetConfig
            ) -> torch.Tensor:
    pred = forward(params, batch, cfg)
    err = (pred - batch["targets"].to(pred.dtype)) ** 2
    mask = batch.get("node_mask")
    if mask is not None:
        err = torch.where(mask[:, None], err, 0)
        return err.float().sum() / (mask.sum() * pred.shape[-1]).clamp(
            min=1)
    return err.float().mean()
