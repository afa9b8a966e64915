"""din [arXiv:1706.06978]: embed_dim=18 seq_len=100 attn_mlp=80-40
mlp=200-80, target-attention interaction.  Item catalog 10M rows,
10k categories (huge-sparse-embedding regime)."""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.recsys.din import DINConfig


def make_config() -> DINConfig:
    return DINConfig(name="din", embed_dim=18, seq_len=100,
                     n_items=10_000_000, n_cates=10_000,
                     attn_mlp=(80, 40), mlp=(200, 80))


def make_reduced() -> DINConfig:
    return DINConfig(name="din-reduced", embed_dim=8, seq_len=20,
                     n_items=1000, n_cates=32, attn_mlp=(16, 8), mlp=(24, 12))


SPEC = ArchSpec("din", "recsys", "arXiv:1706.06978", make_config, make_reduced)
