"""Shared model building blocks (plain functions over tensors).

``dense_init``, ``mlp`` / ``init_mlp`` and ``cross_entropy_loss`` (the
GNNs and the transformer), ``rms_norm`` and ``layer_norm`` (the
transformer).  Where the JAX package computes in float32 whatever the
input dtype, so does the port (:func:`wide`), but a float64 input stays
float64: the gradient checks' float64 arbiter runs every operation in
float64.
"""

from __future__ import annotations

import torch


def dense_init(generator: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (the JAX package's distribution, not
    its bits: the two frameworks draw different numbers from one seed).
    Drawn on the generator's device, then moved to ``device``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype=dtype, device=device)


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, the dtype the JAX package's norms, attention
    scores, router and losses compute in, or as it is where it is
    float64."""
    return t if t.dtype == torch.float64 else t.float()


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, computed in f32 (:func:`wide`), cast
    back to x's dtype."""
    xf = wide(x)
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * wide(scale)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32 (:func:`wide`), cast
    back to x's dtype."""
    xf = wide(x)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * wide(scale)
    if bias is not None:
        y = y + wide(bias)
    return y.to(x.dtype)


def mlp(params_prefix: dict, x: torch.Tensor, names: list[str],
        act=torch.relu, final_act=None) -> torch.Tensor:
    """Apply a stack of dense layers ``names`` from a params dict holding
    ``{name}_w`` / ``{name}_b``: ``act`` between layers, ``final_act``
    (if any) after the last."""
    for i, n in enumerate(names):
        x = x @ params_prefix[f"{n}_w"] + params_prefix[f"{n}_b"]
        if i < len(names) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def init_mlp(generator: torch.Generator, sizes: list[int], names: list[str],
             dtype=torch.float32, device=None) -> dict:
    """``{name}_w`` (truncated-normal fan-in, ``sizes[i] x sizes[i+1]``)
    and zero ``{name}_b`` for each layer of :func:`mlp`."""
    if len(sizes) != len(names) + 1:
        raise ValueError(f"{len(sizes)} sizes for {len(names)} layers")
    out = {}
    for i, n in enumerate(names):
        out[f"{n}_w"] = dense_init(generator, (sizes[i], sizes[i + 1]),
                                   dtype=dtype, device=device)
        out[f"{n}_b"] = torch.zeros(sizes[i + 1], dtype=dtype, device=device)
    return out


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore: int = -100) -> torch.Tensor:
    """Mean token CE in f32 (:func:`wide`); ``labels == ignore``
    positions are masked."""
    logits = wide(logits)
    valid = labels != ignore
    labels_safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)
