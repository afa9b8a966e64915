"""Binding of the hand-written CUDA kernel ``csrc/compbin_decode.cu``.

The library is built by ``nvcc`` at first use (see
:mod:`repro_torch.kernels.build`) and called through ``ctypes``; the
kernel launches on PyTorch's current stream, allocates nothing and does
not synchronise.  A build or launch failure raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load_library

NAME = "compbin_decode"
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = load_library(NAME)
        fn = lib.compbin_decode_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.compbin_decode_error_string.argtypes = [ctypes.c_int]
        lib.compbin_decode_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.compbin_decode_error_string)
    return _fn


def compbin_decode_cuda(packed: torch.Tensor, out: torch.Tensor,
                        n: int, b: int) -> None:
    """Launch the kernel: ``packed`` uint8[n*b] -> ``out`` int32[n], both
    contiguous on the same CUDA device, ``b`` in 1..4.  The caller has
    checked the arguments; this raises if the launch is refused."""
    fn, errstr = _launcher()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(packed.data_ptr(), out.data_ptr(), n, b, stream)
    if rc != 0:
        raise RuntimeError(
            f"compbin_decode kernel launch failed (n={n}, b={b}): "
            f"CUDA error {rc}: {errstr(rc).decode()}")
