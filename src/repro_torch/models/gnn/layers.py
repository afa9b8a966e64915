"""GNN message-passing primitives over padded edge lists.

Edge lists are padded with ``-1`` (dropped by masking); an id at or
above ``n_nodes`` is dropped too, as XLA's segment sum does in the JAX
package.  Every segment sum here goes through
:func:`repro_torch.kernels.segment_sum.segment_sum`: on a CUDA tensor
that is the hand-written kernel for every ``n_nodes`` (and, where the
messages require grad, its backward kernel), on a CPU tensor its plain
version.  ``scatter_std`` is two ``scatter_mean``s, so both its sums go
through the kernel too.  So does the gradient of :func:`gather` in a
training step on the card: a segment sum of the gradient rows by the
gathered ids, on K2's forward (``_Gather``).  ``scatter_max`` /
``scatter_min`` are the JAX package's XLA ``segment_max``, not a Pallas
kernel, and here ``index_reduce`` (``amax``): it takes the 1-D ids
(``scatter_reduce`` would need an index as wide as the messages) and,
like ``jax.ops.segment_max``, shares a segment's gradient evenly among
tied maxima.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.obs.trace import profiler_range

_count_lock = threading.Lock()


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] with idx == -1 -> zeros (padding).  An id at or above
    ``x.shape[0]`` reads the last row, as the JAX package's gather
    clamps it (``k2_grad``, K2's backward gather, zero-fills such a row
    instead).

    Where ``x`` is a CUDA tensor that requires grad and grad mode is on
    (a training step on the card), the gradient is K2's segment sum of
    the gradient rows by ``idx`` (:class:`_Gather`): a negative id sends
    its row nowhere, an id at or above ``x.shape[0]`` sends it to the
    last row, which it read.  Every other call, the CPU path among them,
    is :func:`gather_plain`.  ``gather.grad_launches`` counts backward
    calls that launched K2 (each also counts on
    ``segment_sum.launches``), and nothing else adds to it."""
    if x.is_cuda and x.requires_grad and torch.is_grad_enabled():
        return _Gather.apply(x, idx)
    return gather_plain(x, idx)


gather.grad_launches = 0


def gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """:func:`gather` in plain PyTorch ops, which autograd differentiates
    through ``index_put_`` (a sort of the ids, then a walk of each run of
    equal ids): the CPU path, and the yardstick the card's is held to."""
    out = x[idx.clamp(0, max(x.shape[0] - 1, 0))]
    return torch.where((idx >= 0)[:, None], out, 0)


class _Gather(torch.autograd.Function):
    """Forward :func:`gather_plain`, bit for bit; backward
    ``segment_sum(grad_out, ids, N)`` in ``x``'s dtype, the ids at or
    above N moved to N - 1 (K2 drops the negative ones).  Saves the ids
    alone."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n, ctx.dtype = x.shape[0], x.dtype
        return gather_plain(x, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        (idx,) = ctx.saved_tensors
        if not grad_out.numel():                # no edge or no column
            return grad_out.new_zeros((ctx.n, grad_out.shape[1]),
                                      dtype=ctx.dtype), None
        with profiler_range("gnn.gather.backward"):
            grad = segment_sum(grad_out, idx.clamp(max=ctx.n - 1), ctx.n)
        if grad_out.is_cuda:
            with _count_lock:
                gather.grad_launches += 1
        return grad.to(ctx.dtype), None


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


def scatter_max(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                neutral: float = -1e30) -> torch.Tensor:
    """Per-segment maximum of ``messages`` by ``dst`` into ``[n_nodes,
    D]``; padding and ids at or above ``n_nodes`` are dropped, and a
    segment that receives nothing gives 0 (its value stays ``neutral``,
    which the ``neutral / 2`` test maps to 0).  Dropped rows are sent to
    segment 0 as ``neutral``, which never beats a real message there."""
    if n_nodes == 0:
        return messages.new_zeros((0, messages.shape[1]))
    valid = (dst >= 0) & (dst < n_nodes)
    msgs = torch.where(valid[:, None], messages, neutral)
    out = torch.full((n_nodes, messages.shape[1]), neutral,
                     dtype=msgs.dtype, device=msgs.device)
    # int64 ids: index_reduce's backward takes no other width
    ids = torch.where(valid, dst, 0).long()
    out = out.index_reduce(0, ids, msgs, "amax", include_self=False)
    return torch.where(out <= neutral / 2, 0.0, out)


def scatter_min(messages: torch.Tensor, dst: torch.Tensor,
                n_nodes: int) -> torch.Tensor:
    return -scatter_max(-messages, dst, n_nodes)


def scatter_std(messages: torch.Tensor, dst: torch.Tensor,
                n_nodes: int) -> torch.Tensor:
    """``sqrt(max(E[m^2] - E[m]^2, 0) + 1e-5)`` per segment; the maximum
    shares its gradient at a tie (a one-message segment, all-zero
    messages) as the JAX package's ``jnp.maximum`` does."""
    mu = scatter_mean(messages, dst, n_nodes)
    mu2 = scatter_mean(messages.square(), dst, n_nodes)
    var = mu2 - mu.square()
    return torch.sqrt(torch.maximum(var, var.new_zeros(())) + 1e-5)


def degree(dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """In-degree over the valid edges (float32[n_nodes])."""
    valid = (dst >= 0).to(torch.float32)
    return segment_sum(valid[:, None], dst, n_nodes)[:, 0]
