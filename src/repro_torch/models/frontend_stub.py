"""Modality frontend stubs: counterpart of `repro.models.frontend_stub`.

The vision and audio frontends are stubs in the reference too: callers
supply precomputed patch or frame embeddings. These helpers make
seeded stand-ins and say how a combined length splits between stub
positions and text tokens. `make_stub_embeddings` draws from a
`torch.Generator`, which cannot give `jax.random`'s numbers, so tests
hand both packages the same numpy embeddings instead.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..configs.base import ModelConfig
from .common import resolve_device


def frontend_split(cfg: ModelConfig, seq_len: int) -> Tuple[int, int]:
    """(stub_positions, text_tokens) for a combined seq_len."""
    if cfg.frontend == "vision_stub":
        n_front = min(cfg.frontend_tokens or seq_len // 2, seq_len - 1)
        return n_front, seq_len - n_front
    if cfg.frontend == "audio_stub":
        # enc-dec: the stub feeds the encoder; the decoder sees seq_len
        return seq_len, seq_len
    return 0, seq_len


def make_stub_embeddings(cfg: ModelConfig, batch: int, n_positions: int,
                         seed: int = 0, device="cuda") -> torch.Tensor:
    """Seeded stand-in patch / frame embeddings [B, N, D] f32, N(0,
    0.02), drawn on `device`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = torch.empty((batch, n_positions, cfg.d_model), dtype=torch.float32,
                      device=dev)
    return out.normal_(0.0, 0.02, generator=gen)
