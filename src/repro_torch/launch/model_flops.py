"""Analytic model FLOPs — the "useful work" numerator of a roofline
share.  Only the LM formula is ported (the JAX package's
``launch/model_flops.py::lm_model_flops``, unchanged): 6*N*D train (N =
params, D = tokens; MoE: N_active), 2*N*D inference, plus the causal
attention term, and the KV-cache attention term for decode.
"""

from __future__ import annotations


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
