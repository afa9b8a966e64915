"""The PNA step's operations: a frozen copy of the PNA branch of the
port's ``launch/model_flops.py::gnn_model_flops``, so that a change to
the program cannot move the yardstick.  The byte counts of K2 and
``k2_grad`` and the card's peaks are ``perfbench/gen/arith.py``'s."""

from __future__ import annotations


def pna_step_flops(n: int, e: int, f: int, d: int, n_layers: int) -> float:
    """One full-graph training step of PNA (``f`` features, ``d``
    hidden, ``n_layers`` layers) on ``n`` nodes and ``e`` edge messages:
    the encoder, each layer's message product on ``[E, 2d]`` and tower
    product on ``[N, 13d]``, times 3 for the backward (the head and the
    aggregations are not counted, as the port's formula leaves them
    out)."""
    per_layer = 2.0 * e * (2 * d) * d + 2.0 * n * (13 * d) * d
    fwd = 2.0 * n * f * d + n_layers * per_layer
    return 3.0 * fwd
