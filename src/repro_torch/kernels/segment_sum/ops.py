"""Public wrapper for the segment-sum kernel (GNN message aggregation).

On the card, :func:`plan` picks one of the kernel's two designs per call
(``csrc/segment_sum.cu`` describes them): ``rows`` sums each output row
in edge order and writes it once, ``atomic`` adds every message element
into a zero-filled output.  Where the messages require grad, the call
goes through a ``torch.autograd.Function`` whose backward is the same
file's gather kernel (:func:`segment_sum_backward`).
:func:`gather_scale_sum` is the same file's fused forward: it gathers,
scales and sums each edge's row of ``x`` without writing a message.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels.segment_sum.ref import (gather_scale_sum_ref,
                                                segment_sum_grad_ref,
                                                segment_sum_ref)

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
#: vector widths of the backward kernel, in floats (16, 8, 4 bytes)
GRAD_VECS = (4, 2, 1)


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


def grad_vector_width(d: int, grad: torch.Tensor, out: torch.Tensor) -> int:
    """The vector width, in floats, of one backward call gathering rows of
    width ``d`` from ``grad`` into ``out``: the widest of
    :data:`GRAD_VECS` that divides ``d`` and whose ``4 * VEC`` bytes both
    data pointers are aligned to.  GCN's hidden width (D = 16) on fresh
    allocations takes 4, D = 6 takes 2, Cora's D = 1433 and a view offset
    by one float take 1.  The CUDA launcher refuses any wider one."""
    return next(v for v in GRAD_VECS if d % v == 0
                and grad.data_ptr() % (4 * v) == 0
                and out.data_ptr() % (4 * v) == 0)


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
        # autograd differentiates the plain version (through index_add_)
        return segment_sum_ref(messages, segment_ids, num_segments)
    if messages.requires_grad and torch.is_grad_enabled():
        return _SegmentSum.apply(messages, segment_ids, num_segments, design)
    return _forward(messages, segment_ids, num_segments, design)


def _forward(messages, segment_ids, num_segments, design):
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


class _SegmentSum(torch.autograd.Function):
    """K2 on the card with its backward kernel: the forward is the call
    :func:`plan` designs, the backward gathers ``grad_out`` by the same
    ids (:func:`segment_sum_backward`), in the messages' dtype."""

    @staticmethod
    def forward(ctx, messages, segment_ids, num_segments, design):
        ctx.save_for_backward(segment_ids)
        ctx.num_segments = num_segments
        ctx.msg_dtype = messages.dtype
        return _forward(messages, segment_ids, num_segments, design)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        (ids,) = ctx.saved_tensors
        grad = segment_sum_backward(grad_out, ids, ctx.num_segments)
        return grad.to(ctx.msg_dtype), None, None, None


def segment_sum_backward(grad_out: torch.Tensor, segment_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """The gradient of :func:`segment_sum` with respect to its messages:
    ``grad_out[segment_ids[e]]`` where the id lies in
    ``[0, num_segments)``, a zero row elsewhere, as float32[E, D].

    ``grad_out`` may be any float32-castable [num_segments, D] view
    (autograd hands over expanded or strided ones); it is made contiguous
    first.  A CUDA tensor goes through the gather kernel, in the vector
    width :func:`grad_vector_width` picks, or raises; a CPU tensor takes
    the plain version.  ``segment_sum.grad_launches`` counts calls that
    launched the kernel (E*D > 0) and nothing else.
    """
    return _segment_sum_backward(grad_out, segment_ids, num_segments, None)


def _segment_sum_backward(grad_out, segment_ids, num_segments, vec):
    if grad_out.ndim != 2 or segment_ids.ndim != 1:
        raise ValueError("grad_out must be [N, D], segment_ids [E]")
    if grad_out.shape[0] != num_segments:
        raise ValueError(f"grad_out has {grad_out.shape[0]} rows for "
                         f"{num_segments} segments")
    if segment_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_ids must be int32 or int64, got "
                        f"{segment_ids.dtype}")
    if segment_ids.device != grad_out.device:
        raise ValueError(f"grad_out on {grad_out.device} but segment_ids "
                         f"on {segment_ids.device}")
    if not grad_out.is_cuda:
        return segment_sum_grad_ref(grad_out, segment_ids, num_segments)
    grad = grad_out.to(torch.float32).contiguous()
    ids = segment_ids.contiguous()
    d = grad.shape[1]
    out = torch.empty(ids.shape[0], d, dtype=torch.float32,
                      device=grad.device)
    if out.numel():
        from repro_torch.kernels.segment_sum.kernel import \
            segment_sum_grad_cuda
        if vec is None:
            vec = grad_vector_width(d, grad, out)
        segment_sum_grad_cuda(grad, ids, out, vec)
        with _launch_lock:
            segment_sum.grad_launches += 1
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

    Differentiable with respect to ``messages``: on the card the
    backward is the gather kernel (:func:`segment_sum_backward`), on the
    CPU autograd differentiates the plain version.
    ``segment_sum.launches`` counts calls that launched the forward
    kernel (one per call, whatever CUDA kernels the design runs) and
    those of the fused forward (:func:`gather_scale_sum`, also counted on
    ``segment_sum.gather_launches``), ``segment_sum.grad_launches`` the
    backward's launches, and nothing else adds to either.
    """
    return _segment_sum(messages, segment_ids, num_segments, None)


segment_sum.launches = 0
segment_sum.grad_launches = 0
segment_sum.gather_launches = 0


def gather_scale_sum(x: torch.Tensor, src: torch.Tensor,
                     weights: torch.Tensor, dst: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """``segment_sum(gather(x, src) * weights[:, None], dst,
    num_segments)`` without the E x D messages: the rows of ``x[NX, D]``
    by ``src[E]`` (an id at or above NX reads row NX - 1, a negative one
    contributes nothing), each scaled by its edge's weight, summed by
    ``dst[E]`` (ids outside ``[0, num_segments)`` dropped) into float32
    ``[num_segments, D]``; ``src`` and ``dst`` are both int32 or both
    int64.

    A CUDA tensor goes through the fused kernel (``k2_gather_atomic``),
    in the vector width :func:`grad_vector_width` picks for ``x`` and the
    zero-filled output, or raises: ``x`` and ``weights`` must be float32
    and need no gradient under grad mode (the kernel has no backward).
    Each product is the unfused chain's single f32 multiply; the adds
    are atomics, in an order that varies from run to run.  A CPU tensor
    takes the plain version, :func:`gather_scale_sum_ref`, bit for bit
    the unfused chain's.  A call that launches the kernel (E x D x N > 0)
    counts once on ``segment_sum.launches`` (it is K2's forward) and once
    on ``segment_sum.gather_launches``; nothing else adds to the latter.
    """
    if x.ndim != 2 or src.ndim != 1 or dst.ndim != 1 or weights.ndim != 1:
        raise ValueError("x must be [NX, D], src, dst and weights [E]")
    e = src.shape[0]
    if not dst.shape[0] == weights.shape[0] == e:
        raise ValueError("E mismatch between src, dst and weights")
    if not (x.is_floating_point() and weights.is_floating_point()):
        raise TypeError(f"x and weights must be floating point, got "
                        f"{x.dtype} and {weights.dtype}")
    for name, ids in (("src", src), ("dst", dst)):
        if ids.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be int32 or int64, got "
                            f"{ids.dtype}")
    if src.dtype != dst.dtype:
        raise TypeError(f"src and dst must share a dtype, got {src.dtype} "
                        f"and {dst.dtype}")
    num_segments = int(num_segments)
    if not 0 <= num_segments < 2 ** 31:
        raise ValueError(f"num_segments must be in [0, 2^31), got "
                         f"{num_segments}")
    if len({t.device for t in (x, src, weights, dst)}) != 1:
        raise ValueError(f"x on {x.device}, src on {src.device}, weights "
                         f"on {weights.device}, dst on {dst.device}")
    if e and not x.shape[0]:
        raise ValueError(f"{e} edges gather from an x of no rows")
    if not x.is_cuda:
        return gather_scale_sum_ref(x, src, weights, dst, num_segments)
    if torch.is_grad_enabled() and (x.requires_grad
                                    or weights.requires_grad):
        raise ValueError("the fused kernel has no backward: x and weights "
                         "must not require grad under grad mode")
    if x.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"the fused kernel takes float32 x and weights, got "
                        f"{x.dtype} and {weights.dtype}")
    x = x.contiguous()
    d = x.shape[1]
    out = torch.zeros((num_segments, d), dtype=torch.float32,
                      device=x.device)
    if e * d * num_segments:
        from repro_torch.kernels.segment_sum.kernel import \
            gather_scale_sum_cuda
        gather_scale_sum_cuda(x, src.contiguous(), dst.contiguous(),
                              weights.contiguous(), out,
                              grad_vector_width(d, x, out))
        with _launch_lock:
            segment_sum.launches += 1
            segment_sum.gather_launches += 1
    return out


def _segment_sum_design(messages: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int, design: str) -> torch.Tensor:
    """:func:`segment_sum` with the CUDA design named instead of planned,
    for the checks and timings that hold each design to the plain
    version; launches count on ``segment_sum.launches``."""
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {sorted(DESIGNS)}, got "
                         f"{design!r}")
    return _segment_sum(messages, segment_ids, num_segments, design)


def _segment_sum_backward_vec(grad_out: torch.Tensor,
                              segment_ids: torch.Tensor, num_segments: int,
                              vec: int) -> torch.Tensor:
    """:func:`segment_sum_backward` with the kernel's vector width named
    (one of :data:`GRAD_VECS`) instead of picked, for the checks that
    hold each width to the plain version.  On the card a width that D or
    the pointers do not allow raises; it never falls back to a narrower
    one.  Launches count on ``segment_sum.grad_launches``."""
    if vec not in GRAD_VECS:
        raise ValueError(f"vec must be one of {GRAD_VECS}, got {vec!r}")
    return _segment_sum_backward(grad_out, segment_ids, num_segments, vec)
