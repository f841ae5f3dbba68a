"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks [arXiv:2405.04517]. d_ff=0: no FFN blocks — the
expansion lives inside the mLSTM projections (factor 2). sLSTM layers at
1-in-6 ratio (xLSTM[a:b] style alternation).
"""

import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm", n_layers=24, d_model=1024,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
        block_kind="xlstm", slstm_every=6, ssm_expand=2,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=4, d_model=32, n_heads=2, n_kv_heads=2,
        vocab_size=128, slstm_every=2, remat=False,
    )
