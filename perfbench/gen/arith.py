"""The yardstick's arithmetic: the card's peaks, the bytes each kernel
must move on its inputs and the GCN step's operations.

Frozen copies of the repository's sound formulas (``chip_smoke.py``'s
``bound_ms``, ``k2_bytes`` and ``k2_grad_bound_ms``, which ``PERF.md``
§6 states; the port's ``launch/model_flops.py::gnn_model_flops`` for
gcn-cora), so that a change to the program cannot move them.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 outside the
#: tensor cores (the GCN configuration runs float32 with TF32 off)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def k1_bytes(n: int, b: int) -> int:
    """K1 decoding ``n`` ids of ``b`` packed bytes: the packed bytes read
    and the int32 ids written."""
    return n * (b + 4)


def k2_bytes(e: int, d: int, n: int, valid: int) -> int:
    """K2 summing ``e`` f32 message rows of width ``d`` into ``n``
    segments: the ``valid`` rows read (a dropped id's row need not be),
    the ``e`` int32 ids read, the ``n * d`` sums written."""
    return 4 * valid * d + 4 * e + 4 * n * d


def k2_grad_bytes(e: int, d: int, rows: int) -> int:
    """K2's backward gather: each of the ``rows`` distinct rows of the
    f32 output gradient that a valid id names read once, the ``e x d``
    gradient written and the ``e`` int32 ids read."""
    return 4 * rows * d + 4 * e * d + 4 * e


def gcn_step_flops(n: int, e: int, f: int, d: int, c: int) -> float:
    """One full-graph training step of a 2-layer GCN (``f`` features,
    ``d`` hidden, ``c`` classes) on ``n`` nodes and ``e`` edges: the
    forward's products and aggregations, times 3 for the backward."""
    fwd = 2.0 * n * (f * d + d * c) + 2.0 * e * (f + d)
    return 3.0 * fwd


def roofline_share(nbytes: float, seconds: float) -> float | None:
    """Percent of the HBM bound: the least time for ``nbytes`` over the
    time taken.  None where nothing was timed."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
