"""Analytic MODEL_FLOPS per (arch, shape) — the "useful work" numerator
of a roofline share (the JAX package's ``launch/model_flops.py``,
unchanged).

LM: 6*N*D train (N = params, D = tokens; MoE: N_active), 2*N*D
inference, plus the causal attention term, and the KV-cache attention
term for decode.  GNN/recsys: per-op counts (documented inline) —
matmul-dominated terms only, gathers/scatters count as bytes not FLOPs.
"""

from __future__ import annotations

from repro_torch.configs import get_arch
from repro_torch.configs.shapes import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES


def lm_model_flops(cfg, shape) -> float:
    """FLOPs of one step of ``shape`` (``kind`` "train" | "prefill" |
    "decode", ``global_batch``, ``seq_len``; see
    :class:`repro_torch.configs.shapes.LMShape`) on ``cfg``."""
    n_act = cfg.n_active_params()
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        core = 6.0 * n_act * B * S
        # causal attention: 2 matmuls x 2 ops x S^2/2 x fwd+bwd(3x)
        attn = 3.0 * 2.0 * 2.0 * B * cfg.n_layers * cfg.n_heads * cfg.d_head * S * S / 2
        return core + attn
    if shape.kind == "prefill":
        core = 2.0 * n_act * B * S
        attn = 2.0 * 2.0 * B * cfg.n_layers * cfg.n_heads * cfg.d_head * S * S / 2
        return core + attn
    # decode: one token, full KV read
    core = 2.0 * n_act * B
    attn = 2.0 * 2.0 * B * cfg.n_layers * cfg.n_heads * cfg.d_head * shape.seq_len
    return core + attn


def gnn_model_flops(arch_id: str, cfg, shape) -> float:
    """FLOPs of one training step of ``arch_id`` on a ``GNNShape`` (N
    nodes, E edges, F features): forward + backward (3x the forward)."""
    N, E, F = shape.n_nodes, shape.n_edges, shape.d_feat
    train_mult = 3.0  # fwd + bwd(2x)
    if arch_id == "gcn-cora":
        d = cfg.d_hidden
        fwd = 2.0 * N * (F * d + d * cfg.n_classes) + 2.0 * E * (F + d)
    elif arch_id == "pna":
        d = cfg.d_hidden
        per_layer = 2.0 * E * (2 * d) * d + 2.0 * N * (13 * d) * d
        fwd = 2.0 * N * F * d + cfg.n_layers * per_layer
    elif arch_id == "meshgraphnet":
        d = cfg.d_hidden
        per_layer = 2.0 * E * (3 * d) * d + 2.0 * E * d * d \
            + 2.0 * N * (2 * d) * d + 2.0 * N * d * d
        fwd = 2.0 * (N * cfg.d_node_in + E * cfg.d_edge_in) * d \
            + cfg.n_layers * per_layer
    elif arch_id == "dimenet":
        d = cfg.d_hidden
        T = int(shape.triplet_factor * E)
        nsr = cfg.n_spherical * cfg.n_radial
        per_block = (2.0 * T * (d * cfg.n_bilinear + nsr * cfg.n_bilinear)
                     + 2.0 * E * (cfg.n_bilinear * d + 2 * d * d))
        fwd = 2.0 * E * (2 * cfg.d_in + cfg.n_radial) * d + cfg.n_blocks * per_block
    else:
        raise KeyError(arch_id)
    return train_mult * fwd


def din_model_flops(cfg, shape) -> float:
    """FLOPs of DIN on a ``RecsysShape``: per candidate the attention
    MLP over ``seq_len`` history items and the final MLP; training is 3x
    (forward + backward), retrieval counts ``n_candidates``."""
    d = cfg.d_item
    S = cfg.seq_len
    a1, a2 = cfg.attn_mlp
    m1, m2 = cfg.mlp
    per_cand = (2.0 * S * (4 * d * a1 + a1 * a2 + a2)
                + 2.0 * (3 * d * m1 + m1 * m2 + m2))
    if shape.kind == "train":
        return 3.0 * shape.batch * per_cand
    if shape.kind == "retrieval":
        return float(shape.n_candidates) * per_cand
    return float(shape.batch) * per_cand


def model_flops(arch_id: str, shape_id: str) -> float:
    """FLOPs of the cell (``arch_id``, ``shape_id``) on the full config."""
    spec = get_arch(arch_id)
    cfg = _full_cfg(arch_id)
    if spec.family == "lm":
        return lm_model_flops(cfg, LM_SHAPES[shape_id])
    if spec.family == "gnn":
        return gnn_model_flops(arch_id, cfg, GNN_SHAPES[shape_id])
    return din_model_flops(cfg, RECSYS_SHAPES[shape_id])


def _full_cfg(arch_id: str):
    spec = get_arch(arch_id)
    return spec.make_config()
