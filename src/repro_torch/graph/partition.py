"""Edge partitioning for distributed full-graph GNN training.

Full-graph message passing shards the *edge list* across devices; each
device computes gather(src) -> message -> partial segment-sum, and partials
are reduced with a psum over the edge-shard axis (models/gnn/layers.py).
The partitioner pads every shard to a common length so the result is a
dense (n_shards, shard_len) array — shardable by a ShapeDtypeStruct.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.csr import CSR


def edge_balanced_partition(csr: CSR, n_shards: int, *, pad_value: int = -1
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Split the COO edge list into ``n_shards`` equal (padded) shards.

    Returns (src, dst) of shape [n_shards, shard_len] with ``pad_value``
    marking padding (segment ops drop ids < 0).
    """
    src, dst = csr.edge_index()
    E = src.shape[0]
    shard_len = -(-E // n_shards)
    total = shard_len * n_shards
    src_p = np.full(total, pad_value, dtype=np.int64)
    dst_p = np.full(total, pad_value, dtype=np.int64)
    src_p[:E] = src
    dst_p[:E] = dst
    return src_p.reshape(n_shards, shard_len), dst_p.reshape(n_shards, shard_len)


def vertex_range_partition(csr: CSR, n_parts: int) -> list[tuple[int, int]]:
    """Contiguous vertex ranges with approximately equal edge counts
    (mirrors GraphHandle.partition_plan but for in-memory CSR)."""
    total = csr.n_edges
    targets = [(total * (i + 1)) // n_parts for i in range(n_parts)]
    cuts = np.searchsorted(csr.offsets, targets, side="left")
    cuts = np.clip(cuts, 1, csr.n_vertices)
    bounds = [0] + sorted(set(int(c) for c in cuts))
    if bounds[-1] != csr.n_vertices:
        bounds.append(csr.n_vertices)
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]


def _normalized_shares(shares, process_count: int) -> np.ndarray:
    s = np.asarray(shares, dtype=np.float64)
    if s.shape != (process_count,):
        raise ValueError(f"shares shape {s.shape} != ({process_count},)")
    if np.any(s < 0) or s.sum() <= 0:
        raise ValueError("shares must be >= 0 with a positive sum")
    return s / s.sum()


def _clip_entries(plan: list[tuple[int, int]], a: int, b: int
                  ) -> list[tuple[int, int]]:
    """Plan entries intersected with vertex range [a, b)."""
    out = []
    for v0, v1 in plan:
        lo, hi = max(v0, a), min(v1, b)
        if lo < hi:
            out.append((lo, hi))
    return out


def split_plan(plan: list[tuple[int, int]], process_count: int,
               weights=None, *, shares=None, align: int = 1
               ) -> list[list[tuple[int, int]]]:
    """Assign a partition plan's entries to ``process_count`` processes.

    Each process receives a *contiguous* run of plan entries (so its
    vertex coverage is one contiguous range and its storage reads stay
    sequential — the access pattern PG-Fuse readahead is built for).
    With the defaults, the concatenation of the returned slices is
    exactly ``plan``: ranges across processes are disjoint and cover the
    same vertices.

    ``weights`` (per-entry work, e.g. edge counts) balances the cut
    points; plans from ``GraphHandle.partition_plan`` are already
    edge-balanced, so the default equal-weight split inherits that
    balance.  Greedy cumulative-target cutting bounds every process at
    ``total * share + max(weights)``.  With more processes than entries
    the trailing processes receive empty slices.

    ``shares`` (per-process capacity fractions, normalized internally)
    sizes the slices unevenly — the straggler-aware mode: a host measured
    at half the others' bandwidth passes half their share and receives
    roughly half their work (see :func:`resplit_from_stats`).

    ``align`` > 1 snaps every inter-host cut VERTEX to the nearest
    multiple of ``align``, splitting plan entries where needed (the
    returned ranges still tile the plan's coverage exactly, but entry
    boundaries may move).  Pass ``align = block_size // row_stride`` of a
    fixed-stride store whose data section is block-aligned
    (``featstore.write_featstore(data_align=block_size)``) and
    neighboring hosts' private PG-Fuse caches never fetch the same
    feature block — the cut lands exactly on a block boundary instead of
    mid-block, where both hosts would pay for the full 32 MiB block.
    """
    if process_count < 1:
        raise ValueError(f"process_count must be >= 1, got {process_count}")
    if align < 1:
        raise ValueError(f"align must be >= 1, got {align}")
    n = len(plan)
    w = np.ones(n) if weights is None else np.asarray(weights, dtype=np.float64)
    if w.shape != (n,):
        raise ValueError(f"weights shape {w.shape} != ({n},)")
    if np.any(w < 0):
        raise ValueError("weights must be >= 0")
    cum_share = (np.arange(1, process_count + 1) / process_count
                 if shares is None
                 else np.cumsum(_normalized_shares(shares, process_count)))
    cum = np.concatenate([[0.0], np.cumsum(w)])
    total = cum[-1]
    bounds = [0]
    for i in range(process_count):
        target = total * cum_share[i]
        cut = int(np.searchsorted(cum, target, side="left"))
        bounds.append(min(n, max(bounds[-1], cut)))
    bounds[-1] = n
    if align == 1 or n == 0:
        return [plan[bounds[i]: bounds[i + 1]] for i in range(process_count)]

    # vertex-level cuts snapped to the block grid (monotonic, clamped to
    # the plan's coverage); entries crossing a snapped cut are split
    v_lo, v_hi = plan[0][0], plan[-1][1]
    cuts = [v_lo]
    for i in range(1, process_count):
        b = bounds[i]
        v = plan[b][0] if b < n else v_hi
        snapped = int(round(v / align)) * align
        cuts.append(min(max(snapped, cuts[-1]), v_hi))
    cuts.append(v_hi)
    return [_clip_entries(plan, cuts[i], cuts[i + 1])
            for i in range(process_count)]


def host_vertex_range(entries: list[tuple[int, int]]) -> tuple[int, int]:
    """Vertex range [v0, v1) covered by one process's plan slice
    (empty slices cover nothing and report (0, 0))."""
    if not entries:
        return (0, 0)
    return (entries[0][0], entries[-1][1])


def shard_ranges(plan: list[tuple[int, int]], n_shards: int, *,
                 shares=None, align: int = 1) -> list[tuple[int, int]]:
    """Contiguous per-shard vertex ranges ``[v0, v1)`` for the sharded
    serving path, cut from an edge-balanced partition plan.

    A thin composition of :func:`split_plan` (the same slicer the
    multi-host loader uses, including capacity-``shares`` skew and
    block-grid ``align``) and :func:`host_vertex_range`: each shard's
    slice collapses to its covering vertex range.  The returned ranges
    tile the plan's coverage exactly — a shard the plan could not feed
    (more shards than entries) gets a zero-width range pinned at the
    previous cut, so routing by ``searchsorted`` over the range ends
    never selects it.
    """
    slices = split_plan(plan, n_shards, shares=shares, align=align)
    ranges: list[tuple[int, int]] = []
    prev = plan[0][0] if plan else 0
    for sl in slices:
        if sl:
            v0, v1 = host_vertex_range(sl)
            ranges.append((v0, v1))
            prev = v1
        else:
            ranges.append((prev, prev))
    return ranges


def stream_shares_from_stats(stats, *, floor: float = 0.25) -> np.ndarray:
    """Per-host capacity shares from the previous epoch's ``StreamStats``.

    Host ``i``'s measured loading speed is ``work_i / wall_s_i`` (work =
    streamed edges, or vertices for a pure feature stream); the next
    epoch's :func:`split_plan` ``shares`` are proportional to speed, so a
    straggler — slow NIC, contended OST, busy neighbor VM — receives a
    smaller slice instead of gating the whole cluster at the barrier.

    ``floor`` bounds every share at ``floor / n_hosts`` (a fraction of
    the equal share) before renormalizing: a host that had one terrible
    epoch must keep enough work to be re-measured, or a transient stall
    would starve it forever.  Hosts with no measurement (empty slice,
    zero wall time) are assigned the mean speed of the measured ones.
    All hosts compute identical shares from the same (allgathered) stats,
    so the new cut points agree without further coordination — the same
    no-communication property the original plan split has.
    """
    stats = list(stats)
    k = len(stats)
    if k < 1:
        raise ValueError("need at least one host's stats")
    if not 0 <= floor <= 1:
        raise ValueError(f"floor must be in [0, 1], got {floor}")
    # one work unit for ALL hosts (edges when any host streamed edges,
    # else vertices): mixing units across hosts would make the speeds
    # incomparable — a host whose slice happens to hold an edge-less
    # tail would be scored in vertices/s against its peers' edges/s.
    # A host with zero work in the chosen unit has no measurement and
    # falls into the mean-speed bucket below.
    use_edges = any(s.edges for s in stats)
    speeds = np.zeros(k)
    for i, s in enumerate(stats):
        work = s.edges if use_edges else s.vertices
        wall = getattr(s, "wall_s", 0.0)
        speeds[i] = work / wall if (work and wall > 0) else np.nan
    measured = speeds[~np.isnan(speeds)]
    if measured.size == 0:
        return np.full(k, 1.0 / k)
    speeds = np.where(np.isnan(speeds), measured.mean(), speeds)
    shares = speeds / speeds.sum()
    shares = np.maximum(shares, floor / k)
    return shares / shares.sum()


def resplit_from_stats(plan: list[tuple[int, int]], stats, weights=None, *,
                       align: int = 1, floor: float = 0.25
                       ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
    """Re-split ``plan`` using last epoch's per-host ``StreamStats``.

    The between-epochs hook: measured per-host wall times become capacity
    ``shares`` (:func:`stream_shares_from_stats`) and the SAME global
    plan is re-cut — ``align`` keeps the new cuts on the block grid.
    Returns ``(slices, shares)``; feed ``shares`` to the next epoch's
    :class:`~repro_torch.data.graph_stream.GraphStream` so every process
    derives the identical re-split.
    """
    stats = list(stats)
    shares = stream_shares_from_stats(stats, floor=floor)
    return (split_plan(plan, len(stats), weights, shares=shares,
                       align=align), shares)
