"""Binding of the hand-written CUDA kernel ``csrc/flash_attention.cu``.

The library is built by ``nvcc`` at first use (see
:mod:`repro_torch.kernels.build`) and called through ``ctypes``; the
kernel launches on PyTorch's current stream, allocates nothing and does
not synchronise.  A build or launch failure raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load_library

NAME = "flash_attention"
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = load_library(NAME)
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attention_error_string)
    return _fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, strides: tuple, *, batch: int,
                         hq: int, hkv: int, sq: int, dh: int, offset: int,
                         kv_len: int, causal: bool, scale: float,
                         design: int, nsplit: int,
                         workspace: torch.Tensor | None) -> None:
    """Launch the kernel's ``design`` (0 tc_prefill, 1 fma, 2
    split_decode over ``nsplit`` key ranges, merging through the f32
    ``workspace`` when ``nsplit > 1``).  ``strides`` holds the element
    strides ``(batch, head, seq)`` of q, k, v and out, in that order (12
    ints); the last dimension of each is contiguous.  The caller has
    checked the arguments; this raises if the launch is refused."""
    fn, errstr = _launcher()
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return flash_attention_cuda(
                q, k, v, out, strides, batch=batch, hq=hq, hkv=hkv, sq=sq,
                dh=dh, offset=offset, kv_len=kv_len, causal=causal,
                scale=scale, design=design, nsplit=nsplit,
                workspace=workspace)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *strides, batch, hq, hkv, sq, dh, offset, kv_len, int(causal),
            float(scale), int(q.dtype == torch.bfloat16), design, nsplit,
            None if workspace is None else workspace.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed (B={batch}, Hq={hq}, "
            f"Hkv={hkv}, Sq={sq}, Dh={dh}, kv_len={kv_len}, design={design}, "
            f"nsplit={nsplit}): CUDA error "
            f"{rc}: {errstr(rc).decode()}")


def smem_bytes(design: int, dh: int, bf16: bool) -> int:
    """Dynamic shared memory a block of ``design`` requests (for
    reports); builds the library if need be."""
    fn = load_library(NAME).flash_attention_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(design, dh, int(bf16))
