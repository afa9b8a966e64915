"""The plain reference of the graph cells: the generator's own CSR.

The benchmark draws the graph (``perfbench/gen/kronecker.py``), writes
it as CompBin for the program to read, and keeps the CSR.  Here the
program's outputs are held to that CSR id for id: a load's device
shards, and a query's int64 adjacency lists.  Both comparisons are
exact; each returns the count of what differs (0 when correct).

Imports torch and numpy only: nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(ids) -> np.ndarray:
    """``ids`` (a tensor on any device, or an array) as host int64."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    return np.asarray(ids).astype(np.int64, copy=False)


def shard_mismatches(shards, offsets, neighbors) -> int:
    """Held against the CSR (``offsets`` int64[|V|+1] and ``neighbors``,
    host arrays or tensors), the shards of one load (objects with
    ``v0``, ``v1``, rebased ``offsets`` and ``neighbors``, on any
    device): the count of offsets and ids that differ, plus every vertex
    no shard covers or more than one covers."""
    n = len(offsets) - 1
    bad = 0
    covered = 0
    for s in sorted(shards, key=lambda s: s.v0):
        if s.v0 != covered:
            bad += abs(s.v0 - covered)        # a gap or an overlap
        covered = max(covered, s.v1)
        lo, hi = int(offsets[s.v0]), int(offsets[s.v1])
        want_off = _host(offsets[s.v0:s.v1 + 1]) - lo
        got_off = _host(s.offsets)
        if got_off.shape != want_off.shape:
            bad += max(got_off.size, want_off.size)
        else:
            bad += int((got_off != want_off).sum())
        want = _host(neighbors[lo:hi])
        got = _host(s.neighbors)
        m = min(got.size, want.size)
        bad += int((got[:m] != want[:m]).sum()) + abs(got.size - want.size)
    return bad + abs(n - covered)


def answer_mismatches(vertices: np.ndarray, answers, offsets: np.ndarray,
                      neighbors: np.ndarray) -> int:
    """Held against the CSR (host arrays), one request's answers (a list
    of arrays, the adjacency list of each id in ``vertices``, in order):
    the count of ids that differ or are missing or extra, plus every
    answer that is missing or not int64."""
    vertices = np.asarray(vertices, dtype=np.int64)
    if len(answers) != len(vertices):
        return abs(len(answers) - len(vertices)) + int(
            offsets[vertices + 1].sum() - offsets[vertices].sum())
    bad = sum(int(np.asarray(a).dtype != np.int64) for a in answers)
    lo, hi = offsets[vertices], offsets[vertices + 1]
    lens = np.array([np.asarray(a).size for a in answers], dtype=np.int64)
    want_lens = hi - lo
    bad += int(np.abs(lens - want_lens).sum())
    ok = lens == want_lens
    if ok.any():
        ln = want_lens[ok]
        first = np.cumsum(ln) - ln
        idx = (np.arange(int(ln.sum()), dtype=np.int64)
               + np.repeat(lo[ok] - first, ln))
        got = np.concatenate([np.asarray(a, dtype=np.int64)
                              for a, k in zip(answers, ok) if k]
                             + [np.zeros(0, np.int64)])
        bad += int((got != neighbors[idx].astype(np.int64)).sum())
    return bad


def lower_precision(ids, b: int):
    """The control's ids: each kept in ``b - 1`` bytes, the width below
    the one the file states (ids at or above ``2**(8(b-1))`` wrap)."""
    return ids & ((1 << (8 * (b - 1))) - 1)


def control_answers(vertices: np.ndarray, offsets: np.ndarray,
                    neighbors: np.ndarray, b: int) -> list:
    """The reference's answers to one request at the control's
    precision."""
    return [lower_precision(neighbors[offsets[v]:offsets[v + 1]]
                            .astype(np.int64), b) for v in vertices]


def control_shards(shards, offsets, neighbors, b: int) -> list:
    """One load's shards as the reference would give them at the
    control's precision: the same vertex ranges, the reference's
    offsets and its ids in ``b - 1`` bytes."""
    from types import SimpleNamespace
    out = []
    for s in shards:
        lo, hi = int(offsets[s.v0]), int(offsets[s.v1])
        out.append(SimpleNamespace(
            v0=s.v0, v1=s.v1, offsets=_host(offsets[s.v0:s.v1 + 1]) - lo,
            neighbors=lower_precision(_host(neighbors[lo:hi]), b)))
    return out
