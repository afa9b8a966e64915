"""The GCN cell's initial weights, drawn on the device from a seed.

A 2-layer GCN's leaves in their plain shapes: ``w{i}`` ``[d_i, d_{i+1}]``
with ``d = [d_in, d_hidden, n_classes]``, each a truncated normal on
``[-2, 2]`` scaled by ``1 / sqrt(fan_in)`` (fan-in ``d_i``, the number of
rows the product sums over), and ``b{i}`` ``[d_{i+1}]`` zero, as the
GCN paper starts them: a leaf that starts at zero holds its change
exactly, where one near 0.1 rounds ``p0 + change`` to float32 and its
change norm reads the rounding (the cell compares that norm).  Both
sides of the comparison start from these tensors: the program's state
and the plain reference.  Imports torch alone.
"""

from __future__ import annotations

import torch

from perfbench.gen.kronecker import generator


def gcn_params(d_in: int, d_hidden: int, n_classes: int, seed: int, device,
               dtype=torch.float32) -> dict:
    """``{"w0", "b0", "w1", "b1"}`` in ``dtype`` on ``device``, the same
    for the same seed on the same device type."""
    gen = generator(seed, device)
    dims = [d_in, d_hidden, n_classes]
    params = {}
    for i in range(len(dims) - 1):
        w = torch.empty((dims[i], dims[i + 1]), dtype=torch.float32,
                        device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        params[f"w{i}"] = (w * dims[i] ** -0.5).to(dtype)
        params[f"b{i}"] = torch.zeros(dims[i + 1], dtype=dtype,
                                      device=device)
    return params
