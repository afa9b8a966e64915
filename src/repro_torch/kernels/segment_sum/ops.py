"""Public wrapper for the segment-sum kernel (GNN message aggregation)."""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels.segment_sum.ref import segment_sum_ref

_launch_lock = threading.Lock()


def segment_sum(messages: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Segment-sum ``messages[E, D]`` by ``segment_ids[E]`` into
    ``[num_segments, D]`` float32.

    Ids outside ``[0, num_segments)`` (the sampler's -1 padding among
    them) are dropped.  Messages of any float dtype are cast to float32
    first, as the JAX package's op does.  A CUDA tensor goes through the
    hand-written kernel for EVERY ``num_segments`` -- the JAX package's
    fallback to XLA above 8192 segments has no counterpart -- or raises;
    a CPU tensor takes the plain version.  The kernel adds with atomics,
    so on the card the f32 sums depend on the order of the adds (within
    rounding of the plain version).

    There is no backward yet: a CUDA tensor that requires grad raises.
    ``segment_sum.launches`` counts kernel launches (and nothing else).
    """
    if messages.ndim != 2 or segment_ids.ndim != 1:
        raise ValueError("messages must be [E, D], segment_ids [E]")
    if messages.shape[0] != segment_ids.shape[0]:
        raise ValueError("E mismatch between messages and segment_ids")
    if not messages.is_floating_point():
        raise TypeError(f"messages must be floating point, got "
                        f"{messages.dtype}")
    if segment_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_ids must be int32 or int64, got "
                        f"{segment_ids.dtype}")
    num_segments = int(num_segments)
    if not 0 <= num_segments < 2 ** 31:
        raise ValueError(f"num_segments must be in [0, 2^31), got "
                         f"{num_segments}")
    if segment_ids.device != messages.device:
        raise ValueError(f"messages on {messages.device} but segment_ids "
                         f"on {segment_ids.device}")
    if not messages.is_cuda:
        return segment_sum_ref(messages, segment_ids, num_segments)
    if messages.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            "segment_sum has no backward kernel yet: the CUDA path takes "
            "no tensor that requires grad (run under torch.no_grad() or "
            "torch.inference_mode())")
    msgs = messages.to(torch.float32).contiguous()
    ids = segment_ids.to(torch.int32).contiguous()
    e, d = msgs.shape
    out = torch.zeros(num_segments, d, dtype=torch.float32,
                      device=msgs.device)
    if e * d and num_segments:
        from repro_torch.kernels.segment_sum.kernel import segment_sum_cuda
        segment_sum_cuda(msgs, ids, out)
        with _launch_lock:
            segment_sum.launches += 1
    return out


segment_sum.launches = 0
