"""Shared model building blocks (plain functions over tensors).

Only what GCN needs is ported: ``dense_init`` and ``cross_entropy_loss``.
The JAX package's ``rms_norm``, ``layer_norm``, ``mlp`` and ``init_mlp``
come with the models that use them.
"""

from __future__ import annotations

import torch


def dense_init(generator: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (the JAX package's distribution, not
    its bits: the two frameworks draw different numbers from one seed)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype=dtype, device=device)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore: int = -100) -> torch.Tensor:
    """Mean token CE in f32; ``labels == ignore`` positions are masked."""
    logits = logits.float()
    valid = labels != ignore
    labels_safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)
