"""Error-feedback quantized gradient all-reduce over a data-parallel
process group.

EF-SGD/1-bit-Adam lineage [Seide et al. 2014; arXiv:2102.02888]: each
rank quantizes (grad + residual) to a few levels on a scale shared by
the group, the quantized values are summed across the group, and the
quantization error is fed back into the next step's residual —
unbiased in the long run, wire traffic cut by 4x (int8 container) vs
f32.

The collectives are real ``torch.distributed`` all-reduces on the group
given, whatever its size (a world of one included): the shared scale's
amax reduced with ``MAX``, the quantized tensor summed with ``SUM`` in
int8 on the wire (NCCL on the card, gloo on the CPU).  A sum in int8
accumulates in int8, so the levels leave headroom for the group size:
``levels = max(1, 127 // axis_size)``.  ``outer_group`` adds a second,
f32 averaging phase across groups (the JAX package's cross-pod
``pmean``).  Rounding is half to even, as ``jnp.round``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


def ef_state_init(grads_like: Any) -> Any:
    """Residual (error-feedback) buffer, same structure as grads, f32."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def _quantize(x: torch.Tensor, levels: int, group
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor quantization with a scale shared by the group
    (all-reduce MAX of the local amax), so dequantization after the int8
    sum is exact w.r.t. the shared grid.  Returns (int8 q, f32 0-d
    scale)."""
    amax = x.abs().max().reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(amax[0], 1e-12) / levels
    q = torch.clamp(torch.round(x / scale), -levels, levels).to(torch.int8)
    return q, scale


def ef_compress_psum(grads: Any, ef: Any, group=None, *, axis_size: int,
                     outer_group: Optional[Any] = None) -> tuple[Any, Any]:
    """Quantized sum over ``group`` (None: the default group) with error
    feedback.

    Returns (mean_grads_f32, new_ef), each shaped like ``grads``.
    ``axis_size`` is the group's size: it bounds the int8 accumulation
    headroom and divides the sum.  ``outer_group`` adds the hierarchical
    second-phase f32 mean across groups.
    """
    levels = max(1, 127 // axis_size)

    def one(g, e):
        x = g.to(torch.float32) + e
        q, scale = _quantize(x, levels, group)
        new_e = x - q.to(torch.float32) * scale         # local residual
        dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)   # s8 wire
        mean = q.to(torch.float32) * scale / axis_size
        if outer_group is not None:
            dist.all_reduce(mean, op=dist.ReduceOp.SUM, group=outer_group)
            mean = mean / dist.get_world_size(outer_group)
        return mean, new_e

    outs = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(ef))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))
