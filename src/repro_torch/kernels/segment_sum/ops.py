"""Public wrapper for the segment-sum kernel (GNN message aggregation).

On the card, :func:`plan` picks one of the kernel's two designs per call
(``csrc/segment_sum.cu`` describes them): ``rows`` sums each output row
in edge order and writes it once, ``atomic`` adds every message element
into a zero-filled output.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels.segment_sum.ref import segment_sum_ref

_launch_lock = threading.Lock()

#: the kernel's designs, by the code its launcher takes
DESIGNS = {"atomic": 0, "rows": 1}
#: most edges the rows design takes: its index pass runs in one block, so
#: its time grows with E alone (PERF.md: both designs up to 2^21 edges)
ROWS_MAX_EDGES = 1 << 21
#: narrowest message rows the rows design takes: below, the atomic
#: design's one launch costs less than rows' index pass and three
#: launches (PERF.md: both designs across D on two id layouts)
ROWS_MIN_WIDTH = 768


def plan(e: int, d: int, n: int) -> str:
    """The design of one CUDA call summing ``e`` message rows of width
    ``d`` into ``n`` segments: ``rows`` where the index pass stays a small
    part of the call (``e <= ROWS_MAX_EDGES``) and the rows are wide
    enough for its index pass to pay (``d >= ROWS_MIN_WIDTH``),
    else ``atomic``.  ``n`` does not enter: both designs write all N
    rows.  At the served shapes (E = 30,720, N = 31,744) this picks rows
    at layer 0 (D = 1433) and atomic at layer 1 (D = 16) and for the
    degrees (D = 1), the faster of the two at each on an H100 (PERF.md).
    The CUDA launcher takes whatever this picks: these limits live here
    alone."""
    del n
    return "rows" if e <= ROWS_MAX_EDGES and d >= ROWS_MIN_WIDTH else \
        "atomic"


def _segment_sum(messages, segment_ids, num_segments, design):
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
    # the kernel reads the ids in their own width: a cast to int32 here
    # would wrap an int64 id of 2^32 into segment 0
    ids = segment_ids.contiguous()
    e, d = msgs.shape
    if design is None:
        design = plan(e, d, num_segments)
    shape = (num_segments, d)
    if design == "rows":
        # every element of the output is written by the kernel
        out = torch.empty(shape, dtype=torch.float32, device=msgs.device)
        work, ws = num_segments * d, torch.empty(
            2 * e + 2, dtype=torch.int32, device=msgs.device)
    else:
        out = torch.zeros(shape, dtype=torch.float32, device=msgs.device)
        work, ws = e * d * num_segments, None
    if work:
        from repro_torch.kernels.segment_sum.kernel import segment_sum_cuda
        segment_sum_cuda(msgs, ids, out, DESIGNS[design], ws)
        with _launch_lock:
            segment_sum.launches += 1
    return out


def segment_sum(messages: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Segment-sum ``messages[E, D]`` by ``segment_ids[E]`` into
    ``[num_segments, D]`` float32.

    Ids outside ``[0, num_segments)`` (the sampler's -1 padding among
    them) are dropped, int64 ids too wide for int32 included.  Messages
    of any float dtype are cast to float32 first, as the JAX package's
    op does.  A CUDA tensor goes through the hand-written kernel for
    EVERY ``num_segments`` -- the JAX package's fallback to XLA above
    8192 segments has no counterpart -- in the design :func:`plan` picks,
    or raises; a CPU tensor takes the plain version.  Under ``rows`` on
    ids in ascending order (the served block's layout) each sum is taken
    in edge order, the same bits on every run; otherwise the kernel adds
    with atomics, so the f32 sums depend on the order of the adds (within
    rounding of the plain version).

    There is no backward yet: a CUDA tensor that requires grad raises.
    ``segment_sum.launches`` counts calls that launched the kernel (one
    per call, whatever CUDA kernels the design runs) and nothing else.
    """
    return _segment_sum(messages, segment_ids, num_segments, None)


segment_sum.launches = 0


def _segment_sum_design(messages: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int, design: str) -> torch.Tensor:
    """:func:`segment_sum` with the CUDA design named instead of planned,
    for the checks and timings that hold each design to the plain
    version; launches count on ``segment_sum.launches``."""
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {sorted(DESIGNS)}, got "
                         f"{design!r}")
    return _segment_sum(messages, segment_ids, num_segments, design)
