"""pna [arXiv:2004.05718]: n_layers=4 d_hidden=75, aggregators
mean-max-min-std, scalers identity-amplification-attenuation."""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.gnn.pna import PNAConfig


def make_config(d_in: int = 64, n_classes: int = 10) -> PNAConfig:
    return PNAConfig(name="pna", n_layers=4, d_hidden=75, d_in=d_in,
                     n_classes=n_classes)


def make_reduced() -> PNAConfig:
    return PNAConfig(name="pna-reduced", n_layers=2, d_hidden=12, d_in=8,
                     n_classes=4)


SPEC = ArchSpec("pna", "gnn", "arXiv:2004.05718", make_config, make_reduced)
