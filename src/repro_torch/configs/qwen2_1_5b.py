"""qwen2-1.5b [dense]: 28L d=1536 12H kv=2 d_ff=8960 vocab=151936.

GQA with QKV bias [arXiv:2407.10671].
"""

import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense", n_layers=28, d_model=1536,
        n_heads=12, n_kv_heads=2, d_ff=8960, vocab_size=151936,
        qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
        vocab_size=128, remat=False,
    )
