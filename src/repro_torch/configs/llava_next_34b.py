"""llava-next-34b [vlm]: 60L d=7168 56H kv=8 d_ff=20480 vocab=64000.

Anyres tiling vision frontend is a STUB: input_specs() provides
precomputed patch embeddings (2880 positions ~ 5 tiles x 576 patches)
prepended to the text tokens [hf:llava-hf/llava-v1.6-*].
"""

import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=20480, vocab_size=64000,
        frontend="vision_stub", frontend_tokens=2880, tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
        vocab_size=128, frontend_tokens=8, remat=False,
    )
