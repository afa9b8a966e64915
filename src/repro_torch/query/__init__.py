"""Random-access serving stack over CompBin + PG-Fuse.

One package, every serving layer: the batched
:class:`NeighborQueryEngine` (dedup -> coalesced gathers -> host/device
eq. (1) decode, the device side on the CUDA ``compbin_decode`` kernel),
the device-resident :class:`HotSetCache` tier above it (decoded hub
runs as int32 tensors on the card, degree-aware admission, trace-driven
prefetch), the :class:`TraversalService` (k-hop/BFS/path, one engine
batch per frontier, admission-gated), the scatter-gather
:class:`ShardedQueryService` (per-shard engines + mounts on one card,
replicated routing), and the deterministic virtual-clock
:class:`LoadGenerator`.  The end-to-end picture — including the
three-tier cache hierarchy (storage blocks / host-RAM PG-Fuse / HBM hot
set) — lives in ``docs/architecture.md``.
"""

from repro_torch.query.engine import (DECODE_MODES,  # noqa: F401
                                      NeighborQueryEngine, QueryFuture,
                                      QueryStats, gather_rows,
                                      merge_query_stats)
from repro_torch.query.hotset import (BYTES_PER_EDGE,  # noqa: F401
                                      HotSetCache, HotSetStats,
                                      merge_hotset_stats)
from repro_torch.query.loadgen import (LoadGenerator,  # noqa: F401
                                       LoadReport, default_cost_fn)
from repro_torch.query.sharded import (RouterStats,  # noqa: F401
                                       ShardedQueryService, ShardReplica)
from repro_torch.query.traversal import (TRAVERSAL_KINDS,  # noqa: F401
                                         AdmissionGate, TraversalError,
                                         TraversalRequest, TraversalResult,
                                         TraversalService, TraversalShed,
                                         TraversalStats)
from repro_torch.query.window import (CLOSE_REASONS,  # noqa: F401
                                      AdaptiveWindow, close_reason_counts)
