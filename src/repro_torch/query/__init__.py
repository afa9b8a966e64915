"""Random-access serving stack over CompBin + PG-Fuse.

This slice of the port holds the batched :class:`NeighborQueryEngine`
(dedup -> coalesced gathers -> host/device eq. (1) decode) and its
adaptive micro-batch window.  The hot-set tier, the traversal and sharded
services and the load generator of the JAX package are not ported yet.
"""

from repro_torch.query.engine import (DECODE_MODES,  # noqa: F401
                                      NeighborQueryEngine, QueryFuture,
                                      QueryStats, gather_rows,
                                      merge_query_stats)
from repro_torch.query.window import (CLOSE_REASONS,  # noqa: F401
                                      AdaptiveWindow, close_reason_counts)
