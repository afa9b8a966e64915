"""Deterministic in-process multi-host simulator for the streaming loader.

Real multi-host training gives every process its own Python interpreter,
its own card and its own PG-Fuse mount of the graph file.  The loader
side of that topology is pure bookkeeping — ``process_index`` /
``process_count`` select a :func:`split_plan` slice of the shared
partition plan — so it can be exercised without ``torch.distributed``:
this module runs N *simulated* processes inside one interpreter, each
with

  * its own :class:`~repro_torch.core.paragrapher.GraphHandle` (and
    therefore its own PG-Fuse ``CachedFile`` + block cache + stats), and
  * its own :class:`~repro_torch.data.graph_stream.GraphStream` carrying
    that process's ``process_index``, placing shards through
    ``host_submesh`` on the one ``device`` every simulated host shares.

Hosts are threads; each stream's decode launches go on the calling
thread's current CUDA stream.  The simulation is deterministic in
everything tests assert on: the plan slices, the shard contents, and
the per-host counters are pure functions of (file, n_parts,
process_count) even though the hosts run concurrently.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from repro_torch.data.graph_stream import (StreamedShard, StreamStats,
                                           merge_stats, stream_partitions)


@dataclasses.dataclass
class HostResult:
    """One simulated process's view of a multi-host streamed load."""

    process_index: int
    shards: list
    stats: StreamStats
    host_range: tuple          # [v0, v1) vertex coverage of this host
    plan: list                 # this host's slice of the global plan
    n_vertices: int = 0        # |V| of the WHOLE graph (coverage checks)


def simulate_hosts(path, process_count: int, device=None, *,
                   open_kwargs: Optional[dict] = None,
                   concurrent: bool = True,
                   **stream_kwargs) -> list[HostResult]:
    """Stream ``path`` as ``process_count`` simulated hosts onto
    ``device`` (None = the GPU, raises without one); return the per-host
    shards and stats ordered by process index.

    ``open_kwargs`` go to :func:`repro_torch.core.paragrapher.open_graph`
    in every simulated process (default: PG-Fuse mounted, as a real host
    would); pass a callable ``open_kwargs(process_index) -> dict`` to give
    each host its own storage backend.  ``stream_kwargs`` go to
    :func:`stream_partitions`; pass ``n_parts`` to pin the global plan
    when comparing runs with different host counts.  ``concurrent=False``
    runs the hosts back to back for debugging; the results are identical
    either way.
    """
    if process_count < 1:
        raise ValueError(f"process_count must be >= 1, got {process_count}")
    if callable(open_kwargs):
        kwargs_for = open_kwargs
    else:
        fixed = dict(open_kwargs) if open_kwargs else {"use_pgfuse": True}
        kwargs_for = lambda i: fixed
    results: list[Optional[HostResult]] = [None] * process_count
    errors: list[BaseException] = []
    err_lock = threading.Lock()

    def run_host(i: int) -> None:
        from repro_torch.core import paragrapher

        try:
            with paragrapher.open_graph(path, **kwargs_for(i)) as g:
                with stream_partitions(g, device, process_index=i,
                                       process_count=process_count,
                                       **stream_kwargs) as stream:
                    shards = list(stream)
                results[i] = HostResult(
                    process_index=i, shards=shards, stats=stream.stats,
                    host_range=stream.host_range, plan=list(stream.plan),
                    n_vertices=g.n_vertices)
        except BaseException as e:
            with err_lock:
                errors.append(e)

    if concurrent and process_count > 1:
        threads = [threading.Thread(target=run_host, args=(i,),
                                    name=f"simhost-{i}", daemon=True)
                   for i in range(process_count)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        for i in range(process_count):
            run_host(i)
    if errors:
        raise errors[0]
    return [r for r in results if r is not None]


def aggregate_stats(results: list[HostResult]) -> StreamStats:
    """Fold the per-host stats into cluster totals (associative merge)."""
    return merge_stats(r.stats for r in results)


def resplit_shares(results: list[HostResult], *, floor: float = 0.25):
    """Next-epoch capacity shares from a simulated epoch's results.

    The straggler-aware loop: ``simulate_hosts`` an epoch, feed the
    measured per-host wall times back through
    :func:`repro_torch.graph.partition.stream_shares_from_stats`, and
    pass the returned shares to the next ``simulate_hosts(...,
    shares=...)`` — a host that loaded slowly gets a proportionally
    smaller slice.
    """
    from repro_torch.graph.partition import stream_shares_from_stats

    ordered = sorted(results, key=lambda r: r.process_index)
    return stream_shares_from_stats([r.stats for r in ordered], floor=floor)


def all_shards(results: list[HostResult]) -> list[StreamedShard]:
    """Every host's shards, ordered by vertex range — ready for
    :func:`repro_torch.launch.data_gnn.streamed_graph_batch` /
    :func:`repro_torch.data.graph_stream.assemble_csr`."""
    return sorted((s for r in results for s in r.shards), key=lambda s: s.v0)
