"""Small bridges between numpy and the port's types.

The graph file is the state both packages share (same bytes on disk);
these functions put in-memory values on one footing too.  They take and
return numpy, so a test can hand them the JAX package's outputs without
this package importing it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.csr import CSR


def csr_from_numpy(offsets, neighbors) -> CSR:
    """The port's :class:`CSR` from any array-likes (int64 offsets; the
    neighbors keep their integer dtype)."""
    return CSR(offsets=np.ascontiguousarray(offsets, dtype=np.int64),
               neighbors=np.ascontiguousarray(neighbors))


def shard_to_numpy(shard) -> tuple[int, int, np.ndarray, np.ndarray]:
    """``(v0, v1, offsets, neighbors)`` of a :class:`StreamedShard` on any
    device, as host numpy arrays."""
    return (int(shard.v0), int(shard.v1),
            shard.offsets.detach().cpu().numpy(),
            shard.neighbors.detach().cpu().numpy())


def stats_ints(stats) -> dict:
    """The integer counters of a ``StreamStats`` / ``QueryStats`` (or any
    stats dataclass) as a plain dict — durations, rates, strings and
    histograms are left out, dict-valued counters are copied."""
    out = {}
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        if isinstance(v, (bool, float)):
            continue
        if isinstance(v, (int, np.integer)):
            out[f.name] = int(v)
        elif isinstance(v, dict):
            out[f.name] = {k: int(n) for k, n in v.items()}
    return out
