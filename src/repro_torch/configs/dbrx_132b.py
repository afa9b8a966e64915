"""dbrx-132b [hf:databricks/dbrx-base]: 40L d_model=6144 48H (GQA kv=8)
d_ff=10752 (per expert) vocab=100352, MoE 16 experts top-4 (fine-grained),
normalized top-k router weights, LayerNorm."""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48,
        n_kv_heads=8, d_head=128, d_ff=0, vocab=100_352, max_seq=32_768,
        qkv_bias=False, norm="layernorm", rope_theta=500_000.0,
        moe=True, n_experts=16, n_experts_padded=16, top_k=4, moe_d_ff=10_752,
        n_shared_experts=0, router_norm_topk=True, dtype=torch.bfloat16,
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        name="dbrx-132b-reduced", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_head=8, d_ff=0, vocab=512, max_seq=128,
        norm="layernorm", moe=True, n_experts=4, n_experts_padded=4,
        top_k=2, moe_d_ff=48, router_norm_topk=True, dtype=torch.float32,
        capacity_factor=2.0,
    )


SPEC = ArchSpec("dbrx-132b", "lm", "hf:databricks/dbrx-base",
                make_config, make_reduced)
