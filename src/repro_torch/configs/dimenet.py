"""dimenet [arXiv:2003.03123]: n_blocks=6 d_hidden=128 n_bilinear=8
n_spherical=7 n_radial=6 — directional (triplet) message passing."""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.gnn.dimenet import DimeNetConfig


def make_config(d_in: int = 16, n_targets: int = 1) -> DimeNetConfig:
    return DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128,
                         n_bilinear=8, n_spherical=7, n_radial=6,
                         d_in=d_in, n_targets=n_targets)


def make_reduced() -> DimeNetConfig:
    return DimeNetConfig(name="dimenet-reduced", n_blocks=2, d_hidden=16,
                         n_bilinear=4, n_spherical=3, n_radial=3, d_in=8)


SPEC = ArchSpec("dimenet", "gnn", "arXiv:2003.03123", make_config, make_reduced)
