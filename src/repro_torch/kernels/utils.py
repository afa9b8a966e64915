"""Shared helpers for the hand-written CUDA kernels and their wrappers."""

from __future__ import annotations

import torch


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def resolve_device(device: "torch.device | str | None" = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU: it resolves to ``cuda`` and RAISES when no
    CUDA device is available — the port never carries on on the CPU by
    itself.  A caller that wants the CPU (the tests do) says
    ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available and no device was given; this "
                "path runs on the GPU unless device='cpu' is asked for")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is "
                               f"not available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
