"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d_model=2048 16H
(GQA kv=16) moe_d_ff=1408 vocab=151936, MoE 60 routed top-4 + 4 shared
(shared intermediate 4x1408=5632, sigmoid shared-expert gate).  60 experts
pad to 64 physical slots so EP=16 divides."""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=16, d_head=128, d_ff=0, vocab=151_936, max_seq=32_768,
        qkv_bias=True, norm="rmsnorm", rope_theta=1_000_000.0,
        moe=True, n_experts=60, n_experts_padded=64, top_k=4, moe_d_ff=1408,
        n_shared_experts=4, shared_d_ff=5632, shared_expert_gate=True,
        router_norm_topk=False, dtype=torch.bfloat16,
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-moe-a2.7b-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=0, vocab=512, max_seq=128,
        qkv_bias=True, norm="rmsnorm",
        moe=True, n_experts=6, n_experts_padded=8, top_k=4, moe_d_ff=32,
        n_shared_experts=2, shared_d_ff=64, shared_expert_gate=True,
        router_norm_topk=False, dtype=torch.float32, capacity_factor=2.0,
    )


SPEC = ArchSpec("qwen2-moe-a2.7b", "lm", "hf:Qwen/Qwen1.5-MoE-A2.7B",
                make_config, make_reduced)
