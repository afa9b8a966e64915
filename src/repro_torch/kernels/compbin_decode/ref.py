"""Plain PyTorch version of the CompBin decode kernel — eq. (1) of the
paper.  The CPU tests run it, and the on-card check holds the CUDA kernel
against it; nothing on the main path calls it when the tensor lies on a
GPU."""

from __future__ import annotations

import torch


def compbin_decode_ref(packed: torch.Tensor, b: int) -> torch.Tensor:
    """Decode little-endian ``b``-byte packed vertex IDs.

    packed: uint8[n * b] (flat) or uint8[n, b].
    returns int32[n] (b <= 4 only; IDs must fit in int32, i.e.
    |V| < 2^31).
    """
    if not 1 <= b <= 4:
        raise ValueError(f"device decode supports b in [1,4], got {b}")
    cols = packed.reshape(-1, b).to(torch.int32)
    acc = torch.zeros(cols.shape[0], dtype=torch.int32, device=packed.device)
    for i in range(b):  # eq. (1): OR(byte_i << 8i)
        acc = acc | (cols[:, i] << (8 * i))
    return acc
