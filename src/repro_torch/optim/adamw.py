"""AdamW with global-norm clipping, warmup+cosine schedule, and f32 master
weights for bf16 params (pure functional, over dicts of tensors).

The state is the JAX package's: ``{"step": int32 0-d, "m": ..., "v": ...
[, "master": ...]}`` with ``m``/``v``/``master`` shaped like the params,
so a checkpoint carries it in either package.  The schedule, the bias
corrections ``b ** step`` and the clip scale are computed in float32
tensors on the params' device, as the reference computes them, so that
lr and every update agree with it to the last float32 bit or so (a
Python float64 schedule would drift by an f32 ulp) and the step makes
no host sync.  ``adamw_update`` returns new tensors; nothing it was
given is changed in place.

Params, grads and state may be nested dicts (and lists) of tensors;
leaves are taken in sorted-key order, as ``jax.tree_util`` takes them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    master_f32: bool = True   # keep f32 master copies of low-precision params


def tree_leaves(tree: Any) -> list:
    """Leaves of a nested dict/list/tuple, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves replaced, in
    :func:`tree_leaves` order, by ``leaves`` (an iterator or a list)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping ``tree``'s structure."""
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in
                                 zip(tree_leaves(tree), *others)])


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(1, cfg.warmup_steps)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments (f32), ``step`` 0 (int32, on the first param's
    device) and, with ``cfg.master_f32``, f32 master copies."""
    device = tree_leaves(params)[0].device
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
    }
    if cfg.master_f32:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig
                 ) -> tuple[Any, dict, dict]:
    """Returns (new_params, new_state, metrics); ``grads`` is shaped like
    ``params`` (or is the list of its leaves in :func:`tree_leaves`
    order)."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    ref = state.get("master", params)

    def upd(p_ref, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m / b1c
        vh = v / b2c
        p32 = p_ref.detach().to(torch.float32)
        p32 = p32 - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * p32)
        return p32, m, v

    out = [upd(*t) for t in zip(tree_leaves(ref), tree_leaves(grads),
                                tree_leaves(state["m"]),
                                tree_leaves(state["v"]))]
    p32s = tree_unflatten(ref, (o[0] for o in out))
    new_m = tree_unflatten(ref, (o[1] for o in out))
    new_v = tree_unflatten(ref, (o[2] for o in out))
    new_params = tree_map(lambda p32, p: p32.to(p.dtype), p32s, params)
    new_state = {"step": step, "m": new_m, "v": new_v}
    if cfg.master_f32:
        new_state["master"] = p32s
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, new_state, metrics
