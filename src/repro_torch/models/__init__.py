"""The model zoo: counterpart of `repro.models` — the unified decoder-only
LM (attention, MoE, Mamba2 and xLSTM stacks; dense and paged caches)
and the encoder-decoder backbone."""

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
from .encdec import (
    decode_step_encdec,
    forward_encdec,
    init_encdec,
    init_encdec_cache,
    prefill_encdec,
)

__all__ = [
    "count_params", "decode_step", "decode_step_paged", "forward",
    "init_cache", "init_lm", "init_paged_pool", "layer_attn_groups",
    "layer_group_index", "prefill", "prefill_paged",
    "decode_step_encdec", "forward_encdec", "init_encdec",
    "init_encdec_cache", "prefill_encdec",
]
