"""smollm-360m [hf:HuggingFaceTB/SmolLM-360M]: llama-arch small —
32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152, tied embeddings."""

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="smollm-360m", n_layers=32, d_model=960, n_heads=15,
        n_kv_heads=5, d_head=64, d_ff=2560, vocab=49_152, max_seq=32_768,
        norm="rmsnorm", tie_embeddings=True, dtype=torch.bfloat16,
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        name="smollm-360m-reduced", n_layers=2, d_model=48, n_heads=3,
        n_kv_heads=1, d_head=16, d_ff=128, vocab=512, max_seq=128,
        norm="rmsnorm", tie_embeddings=True, dtype=torch.float32,
    )


SPEC = ArchSpec("smollm-360m", "lm", "hf:HuggingFaceTB/SmolLM-360M",
                make_config, make_reduced)
