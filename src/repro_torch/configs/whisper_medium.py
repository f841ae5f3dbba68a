"""whisper-medium [audio]: 24L enc + 24L dec, d=1024 16H d_ff=4096 vocab=51865.

Enc-dec with conv frontend STUB: input_specs() provides precomputed frame
embeddings for the encoder [arXiv:2212.04356]. Plain GELU MLPs. The
assigned decode shapes use a 32k decoder self-cache — well-defined for
the dry-run, outlandish for speech (DESIGN.md §4).
"""

import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=51865,
        is_encoder_decoder=True, n_encoder_layers=24, act="gelu",
        frontend="audio_stub", tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, n_encoder_layers=2, d_model=32, n_heads=2,
        n_kv_heads=2, d_ff=64, vocab_size=128, remat=False,
    )
