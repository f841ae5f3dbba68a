"""qwen2.5-14b [dense]: 48L d=5120 40H kv=8 d_ff=13824 vocab=152064.

GQA with QKV bias [hf:Qwen/Qwen2.5-*].
"""

import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=13824, vocab_size=152064,
        qkv_bias=True, tie_embeddings=False, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
        vocab_size=128, remat=False,
    )
