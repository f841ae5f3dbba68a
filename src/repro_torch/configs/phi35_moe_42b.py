"""phi3.5-moe-42b-a6.6b [moe]: 32L d=4096 32H kv=8 d_ff=6400 vocab=32064.

16 experts, top-2 routing [hf:microsoft/Phi-3.5-MoE-instruct].
"""

import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=6400, vocab_size=32064,
        n_experts=16, top_k=2, tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
        vocab_size=128, n_experts=4, top_k=2, remat=False,
    )
