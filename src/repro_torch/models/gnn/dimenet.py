"""DimeNet — Directional Message Passing [arXiv:2003.03123].

Config: n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7, n_radial=6.

Triplet-gather regime: messages live on *edges* m_ji, and each
interaction block refines them with angular information from edge pairs
(k->j, j->i):

    m_ji' = f( m_ji,  sum_k  W_bilinear[ a_SBF(d_kj, alpha_kji) ] ( m_kj ) )

Inputs carry precomputed triplet index lists (t_kj, t_ji) — pairs of edge
indices sharing vertex j — padded with -1.  The radial basis is the paper's
envelope-damped Bessel-like sine basis; the angular basis uses cos(l*alpha)
harmonics in place of spherical Bessel roots, as the JAX package does.

The parameters are the JAX package's dict: ``emb_w`` / ``emb_b`` and one
nested dict ``block{i}`` per interaction block.  Every segment sum -- the
triplet scatter into edges, the edges into nodes, and the per-graph
readout (``jax.ops.segment_sum`` in the JAX package) -- goes through the
segment-sum kernel.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.nn.functional import silu

from repro_torch.models.common import dense_init
from repro_torch.models.gnn import layers as L


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    envelope_p: int = 6
    d_in: int = 16            # node (atom-type) embedding in
    n_targets: int = 1        # regression targets (energy)
    dtype: torch.dtype = torch.float32


def init_params(cfg: DimeNetConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights from ``generator`` (truncated-normal fan-in), zero
    biases."""
    d, nb = cfg.d_hidden, cfg.n_bilinear
    nsr = cfg.n_spherical * cfg.n_radial

    def W(*shape):
        return dense_init(generator, shape, dtype=cfg.dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=device)

    # embedding block: h_ji = MLP([x_j, x_i, rbf(d_ji)])
    p: dict = {"emb_w": W(2 * cfg.d_in + cfg.n_radial, d), "emb_b": zeros(d)}
    for i in range(cfg.n_blocks):
        p[f"block{i}"] = {
            "rbf_w": W(cfg.n_radial, d),                    # radial gate
            "sbf_w": W(nsr, nb),                            # angular -> bilinear
            "down_w": W(d, nb),                             # m_kj -> bilinear
            "up_w": W(nb, d),                               # bilinear -> hidden
            "self_w": W(d, d), "self_b": zeros(d),
            "out_w": W(d, d), "out_b": zeros(d),
            # per-block output head (edge -> node -> target)
            "head_w": W(d, cfg.n_targets),
        }
    return p


def _envelope(r: torch.Tensor, p: int) -> torch.Tensor:
    """Smooth cutoff polynomial u(r) of DimeNet eq. (8), r in [0, 1]."""
    a = -(p + 1) * (p + 2) / 2
    b = p * (p + 2)
    c = -p * (p + 1) / 2
    return (1.0 / r.clamp(min=1e-6) + a * r ** (p - 1) + b * r ** p
            + c * r ** (p + 1))


def _sines(dist: torch.Tensor, cfg: DimeNetConfig) -> torch.Tensor:
    """envelope(d/c) * sin(n pi d / c) for n = 1..n_radial -> [., R]."""
    r = dist[:, None] / cfg.cutoff
    n = torch.arange(1, cfg.n_radial + 1, dtype=torch.float32,
                     device=dist.device)
    return _envelope(r, cfg.envelope_p) * torch.sin(math.pi * n * r)


def radial_basis(dist: torch.Tensor, cfg: DimeNetConfig) -> torch.Tensor:
    """e_RBF(d): envelope(d/c) * sin(n pi d / c) (paper eq. 7)."""
    return _sines(dist, cfg)


def angular_basis(dist_kj: torch.Tensor, angle: torch.Tensor,
                  cfg: DimeNetConfig) -> torch.Tensor:
    """a_SBF(d_kj, alpha): radial sines x cos(l alpha) harmonics -> [T, S*R]."""
    rad = _sines(dist_kj, cfg)                                      # [T, R]
    l = torch.arange(cfg.n_spherical, dtype=torch.float32,
                     device=angle.device)
    ang = torch.cos(l[None, :] * angle[:, None])                    # [T, S]
    return (ang[:, :, None] * rad[:, None, :]).reshape(dist_kj.shape[0], -1)


def forward(params: dict, batch: dict, cfg: DimeNetConfig) -> torch.Tensor:
    """Returns per-graph predictions [n_graphs, n_targets].

    batch: x[N,d_in], pos[N,3], edge_src/dst[E], triplet_kj/ji[T] (edge
    indices), graph_id[N], n_graphs (a Python int).
    """
    x = batch["x"].to(cfg.dtype)
    pos = batch["pos"].to(torch.float32)
    src, dst = batch["edge_src"], batch["edge_dst"]
    t_kj, t_ji = batch["triplet_kj"], batch["triplet_ji"]
    n_graphs = int(batch["n_graphs"])
    E = src.shape[0]

    # geometry
    dvec = L.gather(pos, dst) - L.gather(pos, src)         # edge vectors j->i
    dist = torch.sqrt((dvec * dvec).sum(-1) + 1e-12)
    rbf = radial_basis(dist, cfg)                           # [E, R]

    # triplet angles alpha_kji between edges (k->j) and (j->i)
    v_ji = L.gather(dvec, t_ji)
    v_kj = L.gather(dvec, t_kj)
    cosa = (v_ji * -v_kj).sum(-1) / (
        torch.linalg.vector_norm(v_ji, dim=-1).clamp(min=1e-6)
        * torch.linalg.vector_norm(v_kj, dim=-1).clamp(min=1e-6))
    angle = torch.arccos(cosa.clamp(-1 + 1e-6, 1 - 1e-6))
    d_kj = L.gather(dist[:, None], t_kj)[:, 0]
    sbf = angular_basis(d_kj, angle, cfg)                   # [T, S*R]

    # embedding block
    m = torch.cat([L.gather(x, src), L.gather(x, dst), rbf.to(cfg.dtype)],
                  dim=-1)
    m = silu(m @ params["emb_w"] + params["emb_b"])              # [E, d]

    out = torch.zeros((x.shape[0], cfg.n_targets), dtype=cfg.dtype,
                      device=x.device)
    for i in range(cfg.n_blocks):
        blk = params[f"block{i}"]
        # directional message: bilinear over the angular basis
        m_kj = L.gather(m, t_kj)                            # [T, d]
        tt = (m_kj @ blk["down_w"]) * (sbf.to(cfg.dtype) @ blk["sbf_w"])
        agg = L.scatter_sum(tt, t_ji, E)                    # [E, nb] -> edges
        upd = agg @ blk["up_w"] + (rbf.to(cfg.dtype) @ blk["rbf_w"]) * m
        m = m + silu(silu(upd @ blk["self_w"] + blk["self_b"]) @ blk["out_w"]
                     + blk["out_b"])
        # output block: edges -> nodes -> per-block target contribution
        node = L.scatter_sum(m, dst, x.shape[0])
        out = out + node @ blk["head_w"]

    # per-graph readout (ids < 0 and >= n_graphs dropped)
    return L.scatter_sum(out, batch["graph_id"], n_graphs)


def loss_fn(params: dict, batch: dict, cfg: DimeNetConfig) -> torch.Tensor:
    pred = forward(params, batch, cfg)
    err = (pred - batch["targets"].to(pred.dtype)) ** 2
    return err.float().mean()
