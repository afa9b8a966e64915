from repro_torch.data.graph_stream import (GraphStream, StreamedShard,  # noqa: F401
                                           StreamStats, assemble_csr,
                                           merge_stats, stream_partitions)
from repro_torch.data.prefetch import PrefetchIterator  # noqa: F401
