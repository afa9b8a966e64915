"""The PNA cell's initial weights, drawn on the device from a seed.

The port's leaf names and shapes (``models/gnn/pna.py``): ``enc_w``
``[d_in, d]``; a layer ``i`` ``msg_w{i}`` ``[2 d, d]`` (the message on
``[h_src, h_dst]``) and ``tower_w{i}`` ``[13 d, d]`` (the update on the
node and its 12 scaled views); ``head_w`` ``[d, n_classes]``.  Each
weight is a truncated normal on ``[-2, 2]`` scaled by ``1 /
sqrt(fan_in)`` (its rows), each bias ``*_b`` zero, as
``perfbench/gen/weights.py`` draws the GCN's (a leaf that starts at zero
holds its change exactly).  Both sides of the comparison start from
these tensors.  Imports torch alone.
"""

from __future__ import annotations

import torch

from perfbench.gen.kronecker import generator


def pna_shapes(d_in: int, d_hidden: int, n_classes: int,
               n_layers: int) -> dict:
    """``{leaf: shape}`` in the order the leaves are drawn."""
    d = d_hidden
    shapes = {"enc_w": (d_in, d), "enc_b": (d,)}
    for i in range(n_layers):
        shapes.update({f"msg_w{i}": (2 * d, d), f"msg_b{i}": (d,),
                       f"tower_w{i}": (13 * d, d), f"tower_b{i}": (d,)})
    shapes.update({"head_w": (d, n_classes), "head_b": (n_classes,)})
    return shapes


def pna_params(d_in: int, d_hidden: int, n_classes: int, n_layers: int,
               seed: int, device, dtype=torch.float32) -> dict:
    """The leaves in ``dtype`` on ``device``, the same for the same seed
    on the same device type."""
    gen = generator(seed, device)
    params = {}
    for k, shape in pna_shapes(d_in, d_hidden, n_classes, n_layers).items():
        if len(shape) == 1:
            params[k] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        params[k] = (w * shape[0] ** -0.5).to(dtype)
    return params
