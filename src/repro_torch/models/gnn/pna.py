"""PNA — Principal Neighbourhood Aggregation [arXiv:2004.05718].

Config: n_layers=4, d_hidden=75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation.  Multi-aggregator regime:
4 parallel segment reductions x 3 degree scalers -> 12 concatenated views
-> linear tower, residual connections.

The parameters are the JAX package's flat dict (``enc_w``, ``msg_w{i}``,
``tower_w{i}``, ``head_w`` and their biases); the mean and std go
through the segment-sum kernel, max and min through ``index_reduce``
(:mod:`repro_torch.models.gnn.layers`).  Float32 throughout, IEEE
products (TF32 is never turned on here).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import cross_entropy_loss, dense_init
from repro_torch.models.gnn import layers as L
from repro_torch.obs.trace import profiler_range


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 64
    n_classes: int = 10
    avg_log_degree: float = 2.0   # delta: dataset mean of log(deg+1)
    dtype: torch.dtype = torch.float32


def init_params(cfg: PNAConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights from ``generator`` (truncated-normal fan-in), zero
    biases."""
    def w(shape):
        return dense_init(generator, shape, dtype=cfg.dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=device)

    d = cfg.d_hidden
    params = {"enc_w": w((cfg.d_in, d)), "enc_b": zeros(d)}
    for i in range(cfg.n_layers):
        # pre-message MLP on (h_src || h_dst) and post-aggregation tower
        params[f"msg_w{i}"] = w((2 * d, d))
        params[f"msg_b{i}"] = zeros(d)
        params[f"tower_w{i}"] = w(((12 + 1) * d, d))
        params[f"tower_b{i}"] = zeros(d)
    params["head_w"] = w((d, cfg.n_classes))
    params["head_b"] = zeros(cfg.n_classes)
    return params


def scalers(deg: torch.Tensor, cfg: PNAConfig) -> tuple:
    """PNA eq. 5's amplification and attenuation columns for the
    in-degrees ``deg``: ``log(d + 1) / delta`` and ``delta / log(d + 1)``,
    the latter's log clamped at 1e-2 (a node with no in-edge)."""
    logd = torch.log(deg + 1.0)
    amp = (logd / cfg.avg_log_degree)[:, None]
    att = (cfg.avg_log_degree / logd.clamp(min=1e-2))[:, None]
    return amp, att


def forward(params: dict, batch: dict, cfg: PNAConfig) -> torch.Tensor:
    """Logits ``[N, n_classes]``.  While a ``torch.profiler`` session
    records, the phases open ranges (``obs.trace.profiler_range``):
    ``pna.encode`` (degrees, scalers, encoder) and ``pna.head`` once, and
    ``pna.message`` (gathers, message MLP), ``pna.aggregate`` (the four
    aggregators and their scaled views) and ``pna.update`` (tower,
    residual) once a layer."""
    x = batch["x"].to(cfg.dtype)
    src, dst = batch["edge_src"], batch["edge_dst"]
    n = x.shape[0]
    with profiler_range("pna.encode"):
        # scalers (PNA eq. 5): identity, amplification, attenuation
        amp, att = scalers(L.degree(dst, n), cfg)
        x = x @ params["enc_w"] + params["enc_b"]
    for i in range(cfg.n_layers):
        with profiler_range("pna.message"):
            m_in = torch.cat([L.gather(x, src), L.gather(x, dst)], dim=-1)
            msgs = torch.relu(m_in @ params[f"msg_w{i}"]
                              + params[f"msg_b{i}"])
        with profiler_range("pna.aggregate"):
            aggs = [L.scatter_mean(msgs, dst, n),
                    L.scatter_max(msgs, dst, n),
                    L.scatter_min(msgs, dst, n),
                    L.scatter_std(msgs, dst, n)]
            views = []
            for a in aggs:
                views += [a, a * amp, a * att]
            h = torch.cat([x] + views, dim=-1)
        with profiler_range("pna.update"):
            x = x + torch.relu(h @ params[f"tower_w{i}"]
                               + params[f"tower_b{i}"])
    with profiler_range("pna.head"):
        return x @ params["head_w"] + params["head_b"]


def loss_fn(params: dict, batch: dict, cfg: PNAConfig) -> torch.Tensor:
    logits = forward(params, batch, cfg)
    labels = torch.where(batch["label_mask"], batch["labels"], -100)
    return cross_entropy_loss(logits, labels)
