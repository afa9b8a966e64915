"""qwen2-1.5b [arXiv:2407.10671]: 28L d_model=1536 12H (GQA kv=2)
d_ff=8960 vocab=151936, QKV bias, tied embeddings."""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12,
        n_kv_heads=2, d_head=128, d_ff=8960, vocab=151_936, max_seq=32_768,
        qkv_bias=True, norm="rmsnorm", rope_theta=1_000_000.0,
        tie_embeddings=True, dtype=torch.bfloat16,
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-1.5b-reduced", n_layers=2, d_model=48, n_heads=6,
        n_kv_heads=2, d_head=8, d_ff=128, vocab=512, max_seq=128,
        qkv_bias=True, norm="rmsnorm", tie_embeddings=True, dtype=torch.float32,
    )


SPEC = ArchSpec("qwen2-1.5b", "lm", "arXiv:2407.10671", make_config, make_reduced)
