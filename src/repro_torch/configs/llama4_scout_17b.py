"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H kv=8 d_ff=8192 vocab=202048.

MoE 16 experts top-1 + shared expert, early fusion (text backbone here)
[hf:meta-llama/Llama-4-Scout-17B-16E].
"""

import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=8192, vocab_size=202048,
        n_experts=16, top_k=1, n_shared_experts=1, tie_embeddings=False,
        rope_theta=500_000.0,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
        vocab_size=128, n_experts=4, top_k=1, remat=False,
    )
