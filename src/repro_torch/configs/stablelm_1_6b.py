"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b]: 24L d_model=2048 32H
(kv=32, i.e. MHA) d_ff=5632 vocab=100352, LayerNorm, partial rotary 25%,
QKV bias."""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="stablelm-1.6b", n_layers=24, d_model=2048, n_heads=32,
        n_kv_heads=32, d_head=64, d_ff=5632, vocab=100_352, max_seq=32_768,
        qkv_bias=True, norm="layernorm", rope_pct=0.25, dtype=torch.bfloat16,
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        name="stablelm-1.6b-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab=512, max_seq=128,
        qkv_bias=True, norm="layernorm", rope_pct=0.25, dtype=torch.float32,
    )


SPEC = ArchSpec("stablelm-1.6b", "lm", "hf:stabilityai/stablelm-2-1_6b",
                make_config, make_reduced)
