"""granite-20b [dense]: 52L d=6144 48H kv=1 (MQA) d_ff=24576 vocab=49152.

llama-arch code model [arXiv:2405.04324]. MQA decode is the most
GEMV-shaped attention in the pool.
"""

import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense", n_layers=52, d_model=6144,
        n_heads=48, n_kv_heads=1, d_ff=24576, vocab_size=49152,
        tie_embeddings=False, mlp_kind="plain", act="gelu",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=32, n_heads=4, n_kv_heads=1, d_ff=64,
        vocab_size=128, remat=False,
    )
