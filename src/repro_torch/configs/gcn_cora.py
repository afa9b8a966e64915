"""gcn-cora [arXiv:1609.02907]: n_layers=2 d_hidden=16 sym-normalized
aggregation — the canonical Cora full-batch config."""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.gnn.gcn import GCNConfig


def make_config(d_in: int = 1433, n_classes: int = 7) -> GCNConfig:
    return GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16, d_in=d_in,
                     n_classes=n_classes, norm="sym")


def make_reduced() -> GCNConfig:
    return GCNConfig(name="gcn-cora-reduced", n_layers=2, d_hidden=8,
                     d_in=16, n_classes=4, norm="sym")


SPEC = ArchSpec("gcn-cora", "gnn", "arXiv:1609.02907", make_config, make_reduced)
