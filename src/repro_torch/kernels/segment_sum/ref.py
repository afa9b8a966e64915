"""Plain PyTorch version of the segment-sum kernel.  The CPU tests and
the CPU path run it, and the on-card check holds the CUDA kernel against
it; nothing on the main path calls it when the tensors lie on a GPU."""

from __future__ import annotations

import torch


def segment_sum_ref(messages: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Sum ``messages[e]`` into ``out[segment_ids[e]]``; ids outside
    ``[0, num_segments)`` are dropped.

    messages: float[E, D]; segment_ids: int[E]; returns float32[N, D] on
    the messages' device.
    """
    n_rows, d = messages.shape
    out = torch.zeros(num_segments, d, dtype=torch.float32,
                      device=messages.device)
    if num_segments == 0 or n_rows == 0:
        return out
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(valid, segment_ids, 0).long()
    msgs = torch.where(valid[:, None], messages.float(), 0.0)
    return out.index_add_(0, ids, msgs)


def segment_sum_grad_ref(grad_out: torch.Tensor, segment_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """The backward of :func:`segment_sum_ref` with respect to the
    messages: ``grad_out[segment_ids[e]]`` for ids in
    ``[0, num_segments)``, a zero row elsewhere.

    grad_out: float32[N, D]; segment_ids: int[E]; returns float32[E, D]
    on grad_out's device.
    """
    d = grad_out.shape[1]
    out = torch.zeros(segment_ids.shape[0], d, dtype=torch.float32,
                      device=grad_out.device)
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    out[valid] = grad_out.float()[segment_ids[valid].long()]
    return out


def gather_scale_sum_ref(x: torch.Tensor, src: torch.Tensor,
                         weights: torch.Tensor, dst: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """The fused gather, scale and sum in plain ops:
    :func:`segment_sum_ref` of ``x``'s rows gathered by ``src`` (an id at
    or above ``x.shape[0]`` reads the last row, a negative one a zero
    row, as the GNN gather does) times ``weights[:, None]``, by ``dst``.

    x: float[NX, D]; src, dst: int[E]; weights: float[E]; returns
    float32[num_segments, D] on x's device.
    """
    rows = x[src.clamp(0, max(x.shape[0] - 1, 0))]
    msgs = torch.where((src >= 0)[:, None], rows, 0) * weights[:, None]
    return segment_sum_ref(msgs, dst, num_segments)
