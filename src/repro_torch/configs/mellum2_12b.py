"""mellum2-12b-a2.5b [moe]: 28L d=2304 32H kv=4 hd=128 vocab=98304.

64 experts of width 896 in every layer, top-8, softmax router with the
top-k renormalised, no shared expert; three sliding-window layers
(window 1024, plain RoPE at theta 5e5) to one full-attention layer
(YaRN: factor 16 over an original 8192 positions, beta_fast 32,
beta_slow 1, attention factor 1.27726)
[hf:JetBrains/Mellum2-12B-A2.5B-Instruct]. A port-only configuration
(the reference's registry has no such model, and its `ModelConfig` no
YaRN): kept out of `ARCH_IDS`, whose entries are held equal to the
reference's. `d_ff` is the expert width; the config's
`intermediate_size` (7168) is used by no layer. The config names no
norm on q and k, so none is applied. Routing is dropless
(`capacity_factor` 0): a served token never depends on its batch mates.
"""

import dataclasses

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mellum2-12b-a2.5b", family="moe", n_layers=28, d_model=2304,
        n_heads=32, n_kv_heads=4, head_dim=128, d_ff=896, vocab_size=98304,
        n_experts=64, top_k=8, capacity_factor=0.0, tie_embeddings=False,
        sliding_window=1024, local_global_ratio=3, rope_theta=500_000.0,
        norm_eps=1e-6, yarn_factor=16.0, yarn_original_context=8192,
        yarn_beta_fast=32.0, yarn_beta_slow=1.0,
        yarn_attention_factor=1.2772588722239782,
    )


def smoke() -> ModelConfig:
    """Three windowed layers and one global, window 8, 8 experts top-4;
    YaRN over an original 16 positions, so the smoke's sequences reach
    past it."""
    return dataclasses.replace(
        config(), n_layers=4, d_model=32, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=24, vocab_size=128, n_experts=8, top_k=4,
        sliding_window=8, yarn_original_context=16, remat=False,
    )
