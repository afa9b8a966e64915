"""Public wrapper for the CompBin decode kernel (eq. (1) on the GPU)."""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels.compbin_decode.ref import compbin_decode_ref
from repro_torch.kernels.utils import ceil_div, resolve_device

# Streaming granularity: partitions are padded (host-side, before the H2D
# copy) to a multiple of this many IDs so every transfer in a
# double-buffered stream has one of a few fixed sizes.  The CUDA kernel
# takes ``n`` at run time and needs no padding; the buckets are kept so
# the ``bytes_h2d`` counters stay equal to the JAX package's.
STREAM_GRANULE_IDS = 1 << 15


def stream_bucket_ids(n: int, granule: int = STREAM_GRANULE_IDS) -> int:
    """Bucketed ID count for a partition of ``n`` IDs.

    Rounds up keeping 4 significant bits (quantum 2^(bits-4)), floored at
    1024: at most ~6% padding for any partition, O(16 log n) distinct
    transfer sizes in total.  ``granule`` caps the quantum so very large
    partitions stay aligned to a fixed multiple (uniform transfer sizes
    for the double buffers)."""
    if n <= 1024:
        return 1024
    q = min(1 << max(10, n.bit_length() - 4), granule)
    return ceil_div(n, q) * q


def pad_packed_for_stream(raw: np.ndarray, b: int, *,
                          granule: int = STREAM_GRANULE_IDS
                          ) -> tuple[np.ndarray, int]:
    """Zero-pad a packed uint8 stream up to a :func:`stream_bucket_ids`
    bucket.

    Returns (padded bytes, n_valid_ids).  The caller decodes the whole
    bucket on device and slices ``[:n_valid_ids]`` — padding decodes to
    vertex 0 and is dropped before anything consumes it.
    """
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if raw.size % b:
        raise ValueError(f"packed length {raw.size} not a multiple of b={b}")
    n = raw.size // b
    n_pad = stream_bucket_ids(n, granule)
    if n_pad != n:
        raw = np.pad(raw, (0, (n_pad - n) * b))
    return raw, n


def decode_packed_stream(raw: np.ndarray, b: int, *,
                         device: "torch.device | str | None" = None
                         ) -> tuple[np.ndarray, int]:
    """One-transfer device decode of a host-side packed byte stream.

    The serving path's building block: ``raw`` (uint8, ``n*b`` bytes —
    e.g. a micro-batch's merged packed-byte runs concatenated) is padded
    to a :func:`stream_bucket_ids` bucket, shipped with ONE host-to-device
    copy, decoded by the CUDA kernel, and returned as int64 IDs on host,
    bit-identical to :func:`repro_torch.core.compbin.decode_ids`.  Returns
    ``(ids, bytes_h2d)`` where ``bytes_h2d`` is the padded transfer size
    (what actually crossed the link), so callers can account H2D traffic
    exactly.  ``device=None`` means the GPU and raises without one.
    """
    raw = np.ascontiguousarray(raw, dtype=np.uint8).reshape(-1)
    if raw.size == 0:
        return np.zeros(0, dtype=np.int64), 0
    device = resolve_device(device)
    padded, n = pad_packed_for_stream(raw, b)
    dev = torch.from_numpy(padded).to(device)   # the batch's single H2D
    out = compbin_decode(dev, b)
    return out[:n].cpu().numpy().astype(np.int64), padded.size


_launch_lock = threading.Lock()


def compbin_decode(packed: torch.Tensor, b: int) -> torch.Tensor:
    """Decode CompBin-packed vertex IDs where ``packed`` lies.

    packed: uint8[n*b] (or any contiguous shape with n*b elements,
    little-endian bytes per ID in memory order).  Returns int32[n] on the
    same device.  A CUDA tensor goes through the hand-written kernel (or
    raises); a CPU tensor takes the plain version.

    b in [5,8] (graphs with |V| >= 2^32) is accepted for IDs that still fit
    int32 — the ceiling every on-device consumer has anyway; the zero high
    bytes are checked (this synchronises) and stripped before the kernel,
    so it only ever sees 4 bytes per ID.  IDs >= 2^31 must take the host
    decode path (core.policy.choose_stream_decode routes them there).

    ``compbin_decode.launches`` counts kernel launches (and nothing else).
    """
    if not 1 <= b <= 8:
        raise ValueError(f"b must be in [1,8] for device decode, got {b}")
    if not isinstance(packed, torch.Tensor) or packed.dtype != torch.uint8:
        raise TypeError("packed must be a torch.uint8 tensor, got "
                        f"{getattr(packed, 'dtype', type(packed))}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    if packed.numel() % b:
        raise ValueError(
            f"packed length {packed.numel()} not a multiple of b={b}")
    n = packed.numel() // b
    if b > 4:
        packed = packed.reshape(n, b)
        if bool((packed[:, 4:] != 0).any()):
            raise ValueError(
                f"b={b} packed stream holds IDs >= 2^32; they cannot decode "
                "to int32 lanes — use the host decode path "
                "(core.policy.choose_stream_decode routes this)")
        packed = packed[:, :4].contiguous()
        b = 4
    packed = packed.reshape(-1)
    if not packed.is_cuda:
        return compbin_decode_ref(packed, b)
    out = torch.empty(n, dtype=torch.int32, device=packed.device)
    if n:
        from repro_torch.kernels.compbin_decode.kernel import \
            compbin_decode_cuda
        compbin_decode_cuda(packed, out, n, b)
        with _launch_lock:
            compbin_decode.launches += 1
    return out


compbin_decode.launches = 0


#: codec name -> device stream decoder ``(raw_u8, b, device=) -> (int64
#: ids, bytes_h2d)``.  This is the op-surface registry the query engine and
#: streaming loader resolve through (repro_torch.core.codec declares WHICH
#: codecs are direct; this maps each to its device decode).  LogCSR
#: byte-packs neighbors exactly like CompBin, so one kernel serves both;
#: a codec with a different packed layout registers its own entry.
PACKED_STREAM_DECODERS = {
    "compbin": decode_packed_stream,
    "logcsr": decode_packed_stream,
}


def packed_stream_decoder(codec_name: str):
    """The device stream decoder registered for ``codec_name``."""
    try:
        return PACKED_STREAM_DECODERS[codec_name]
    except KeyError:
        raise ValueError(
            f"no device stream decoder registered for codec "
            f"{codec_name!r}; registered: "
            f"{', '.join(sorted(PACKED_STREAM_DECODERS))}") from None
