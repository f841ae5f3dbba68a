"""gemma3-27b [dense]: 62L d=5376 32H kv=16 d_ff=21504 vocab=262144.

5:1 local:global attention (sliding window 1024), 128k context
[hf:google/gemma-3-*]. head_dim fixed at 128 (not d_model/n_heads).
Five of every six layers are windowed: in the paged cache they form
their own layer group, whose pages retire once they fall behind the
window.
"""

import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense", n_layers=62, d_model=5376,
        n_heads=32, n_kv_heads=16, d_ff=21504, vocab_size=262144,
        head_dim=128, local_global_ratio=5, sliding_window=1024,
        tie_embeddings=True, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=6, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
        vocab_size=128, head_dim=16, sliding_window=8, remat=False,
    )
