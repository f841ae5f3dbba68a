"""Attention decoder, dense and paged: counterpart of the attention-stack
parts of `repro.models`."""

from .transformer import (
    count_params,
    decode_step,
    decode_step_paged,
    forward,
    init_cache,
    init_lm,
    init_paged_pool,
    layer_attn_groups,
    layer_group_index,
    prefill,
    prefill_paged,
)

__all__ = [
    "count_params", "decode_step", "decode_step_paged", "forward",
    "init_cache", "init_lm", "init_paged_pool", "layer_attn_groups",
    "layer_group_index", "prefill", "prefill_paged",
]
