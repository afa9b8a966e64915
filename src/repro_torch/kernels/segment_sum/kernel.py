"""Binding of the hand-written CUDA kernels in ``csrc/segment_sum.cu``:
the segment sum (``segment_sum_launch``), its backward, a gather
(``segment_sum_grad_launch``), and the fused gather, scale and sum
(``gather_scale_sum_launch``).

The library is built by ``nvcc`` at first use (see
:mod:`repro_torch.kernels.build`) and called through ``ctypes``; the
kernel launches on PyTorch's current stream, allocates nothing and does
not synchronise.  A build or launch failure raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load_library

NAME = "segment_sum"
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = load_library(NAME)
        fn = lib.segment_sum_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        grad = lib.segment_sum_grad_launch
        grad.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_void_p]
        grad.restype = ctypes.c_int
        fused = lib.gather_scale_sum_launch
        fused.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_longlong, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_void_p]
        fused.restype = ctypes.c_int
        lib.segment_sum_error_string.argtypes = [ctypes.c_int]
        lib.segment_sum_error_string.restype = ctypes.c_char_p
        _fn = (fn, grad, fused, lib.segment_sum_error_string)
    return _fn


def segment_sum_cuda(messages: torch.Tensor, ids: torch.Tensor,
                     out: torch.Tensor, design: int,
                     workspace: torch.Tensor | None) -> None:
    """Launch the kernel's ``design`` (0 atomic: ``out`` zero-filled, no
    workspace; 1 rows: ``out`` as allocated, every element written, an
    int32 ``workspace`` of 2E+2 entries): ``messages`` f32[E, D] summed by
    ``ids`` int32 or int64 [E] (read in their own width) into ``out``
    f32[N, D], all contiguous on the same CUDA device.  The caller has
    checked the arguments; this raises if the launch is refused."""
    fn, _, _, errstr = _launcher()
    e, d = messages.shape
    n = out.shape[0]
    with torch.cuda.device(messages.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(messages.data_ptr(), ids.data_ptr(),
                int(ids.dtype == torch.int64), out.data_ptr(), e, d, n,
                design, None if workspace is None else workspace.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(
            f"segment_sum kernel launch failed (E={e}, D={d}, N={n}, "
            f"design={design}): CUDA error {rc}: {errstr(rc).decode()}")


def segment_sum_grad_cuda(grad_out: torch.Tensor, ids: torch.Tensor,
                          grad_msgs: torch.Tensor, vec: int) -> None:
    """Launch the backward gather: ``grad_msgs[e] = grad_out[ids[e]]``
    for ids in ``[0, N)``, zero rows elsewhere; ``grad_out`` f32[N, D],
    ``ids`` int32 or int64 [E] (read in their own width), ``grad_msgs``
    f32[E, D] as allocated (every element is written), all contiguous on
    the same CUDA device, moved in vectors of ``vec`` floats (4, 2 or 1).
    The caller has checked the arguments and picked ``vec``; this raises
    if the launch is refused, a ``vec`` that D or either pointer does not
    allow among the reasons."""
    _, fn, _, errstr = _launcher()
    e, d = grad_msgs.shape
    n = grad_out.shape[0]
    with torch.cuda.device(grad_msgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(grad_out.data_ptr(), ids.data_ptr(),
                int(ids.dtype == torch.int64), grad_msgs.data_ptr(), e, d, n,
                vec, stream)
    if rc != 0:
        raise RuntimeError(
            f"segment_sum backward kernel launch failed (E={e}, D={d}, "
            f"N={n}, VEC={vec}): CUDA error {rc}: {errstr(rc).decode()}")


def gather_scale_sum_cuda(x: torch.Tensor, src: torch.Tensor,
                          dst: torch.Tensor, weights: torch.Tensor,
                          out: torch.Tensor, vec: int) -> None:
    """Launch the fused forward: ``out[dst[e]] += weights[e] *
    x[min(src[e], NX - 1)]`` for ``src[e] >= 0`` and ``dst[e]`` in ``[0,
    N)``; ``x`` f32[NX, D], ``src`` and ``dst`` [E] both int32 or both
    int64, ``weights`` f32[E], ``out`` f32[N, D]
    zero-filled, all contiguous on the same CUDA device, moved in vectors
    of ``vec`` floats (4, 2 or 1).  The caller has checked the arguments
    and picked ``vec``; this raises if the launch is refused."""
    _, _, fn, errstr = _launcher()
    e, (nx, d), n = src.shape[0], x.shape, out.shape[0]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), src.data_ptr(), dst.data_ptr(),
                int(src.dtype == torch.int64), weights.data_ptr(),
                out.data_ptr(), e, d, nx, n, vec, stream)
    if rc != 0:
        raise RuntimeError(
            f"gather_scale_sum kernel launch failed (E={e}, D={d}, NX={nx}, "
            f"N={n}, VEC={vec}): CUDA error {rc}: {errstr(rc).decode()}")
