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
