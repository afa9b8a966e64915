"""GNN message-passing primitives over padded edge lists.

Edge lists are padded with ``-1`` (dropped by masking); an id at or
above ``n_nodes`` is dropped too, as XLA's segment sum does in the JAX
package.  Every segment sum here goes through
:func:`repro_torch.kernels.segment_sum.segment_sum`: on a CUDA tensor
that is the hand-written kernel for every ``n_nodes`` (and, where the
messages require grad, its backward kernel), on a CPU tensor its plain
version.  ``scatter_max/min/std`` wait for PNA.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.segment_sum import segment_sum


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] with idx == -1 -> zeros (padding)."""
    out = x[idx.clamp(min=0)]
    return torch.where((idx >= 0)[:, None], out, 0)


def scatter_sum(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                *, use_kernel: bool = False) -> torch.Tensor:
    """Sum ``messages`` by ``dst`` into ``[n_nodes, D]``.

    Unlike the JAX package, the segment-sum kernel is taken whatever
    ``use_kernel`` says (on the card there is one segment sum, the
    kernel).  The flag keeps the reference's result dtype: with
    ``use_kernel=True`` float32, else the messages' dtype.
    """
    out = segment_sum(messages, dst, n_nodes)
    return out if use_kernel else out.to(messages.dtype)


def scatter_mean(messages: torch.Tensor, dst: torch.Tensor,
                 n_nodes: int) -> torch.Tensor:
    s = scatter_sum(messages, dst, n_nodes)
    d = degree(dst, n_nodes)
    return s / d.clamp(min=1)[:, None]


def degree(dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """In-degree over the valid edges (float32[n_nodes])."""
    valid = (dst >= 0).to(torch.float32)
    return segment_sum(valid[:, None], dst, n_nodes)[:, 0]
