"""Optimizers and schedules: counterpart of `repro.optim`. The
reference's error-feedback gradient compression (`compress.py`) goes
with the distributed layer and is not ported yet."""

from .adamw import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from .schedule import linear_warmup_constant, warmup_cosine

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
    "clip_by_global_norm", "global_norm", "linear_warmup_constant",
    "warmup_cosine",
]
