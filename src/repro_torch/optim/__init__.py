"""Optimizers, schedules and the error-feedback int8 gradient
compression of the data-parallel all-reduce: counterpart of
`repro.optim`."""

from .adamw import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from .compress import compressed_psum, compression_ratio, init_residual
from .schedule import linear_warmup_constant, warmup_cosine

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
    "clip_by_global_norm", "compressed_psum", "compression_ratio",
    "global_norm", "init_residual", "linear_warmup_constant",
    "warmup_cosine",
]
