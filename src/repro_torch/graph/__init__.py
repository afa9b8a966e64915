from repro_torch.graph.features import (LABEL_FAMILY_D,  # noqa: F401
                                        featstore_for_graph,
                                        labelstore_for_graph,
                                        synthesize_node_features,
                                        synthesize_node_labels,
                                        synthesize_separable_labels,
                                        write_node_features)
from repro_torch.graph.generators import erdos_renyi, rmat  # noqa: F401
from repro_torch.graph.partition import (edge_balanced_partition,  # noqa: F401
                                         resplit_from_stats, split_plan,
                                         stream_shares_from_stats)
from repro_torch.graph.sampler import NeighborSampler, SampledBlock  # noqa: F401
