"""zamba2-1.2b [hybrid]: 38L d=2048 32H kv=32 d_ff=8192 vocab=32000, N=64.

Mamba2 backbone + one weight-shared full transformer block applied every
6th layer (6 sites) [arXiv:2411.15242]. d_inner = 2*d = 4096, 32 SSM heads
(P=128), state N=64.
"""

import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32000,
        block_kind="mamba", ssm_state=64, ssm_heads=32, ssm_expand=2,
        attn_every=6, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=4, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
        vocab_size=128, ssm_state=8, ssm_heads=4, attn_every=2, remat=False,
    )
