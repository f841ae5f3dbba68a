"""Paged attention decoder: counterpart of the attention-stack parts of
`repro.models`."""

from .transformer import (
    decode_step_paged,
    init_lm,
    init_paged_pool,
    layer_attn_groups,
    layer_group_index,
    prefill_paged,
)

__all__ = [
    "decode_step_paged", "init_lm", "init_paged_pool", "layer_attn_groups",
    "layer_group_index", "prefill_paged",
]
