"""meshgraphnet [arXiv:2010.03409]: n_layers=15 d_hidden=128 sum
aggregation, 2-layer MLPs — encode-process-decode mesh simulation."""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.gnn.meshgraphnet import MeshGraphNetConfig


def make_config(d_node_in: int = 16, d_edge_in: int = 8) -> MeshGraphNetConfig:
    return MeshGraphNetConfig(name="meshgraphnet", n_layers=15, d_hidden=128,
                              mlp_layers=2, d_node_in=d_node_in,
                              d_edge_in=d_edge_in, d_out=3)


def make_reduced() -> MeshGraphNetConfig:
    return MeshGraphNetConfig(name="meshgraphnet-reduced", n_layers=2,
                              d_hidden=16, mlp_layers=2, d_node_in=8,
                              d_edge_in=4, d_out=3)


SPEC = ArchSpec("meshgraphnet", "gnn", "arXiv:2010.03409",
                make_config, make_reduced)
