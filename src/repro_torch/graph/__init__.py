from repro_torch.graph.generators import erdos_renyi, rmat  # noqa: F401
from repro_torch.graph.partition import (edge_balanced_partition,  # noqa: F401
                                         resplit_from_stats, split_plan,
                                         stream_shares_from_stats)
