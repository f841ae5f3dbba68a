"""Carry the reference's parameters across: JAX `init_lm` tree -> the
port's parameter tree.

The caller converts the JAX tree to numpy arrays (`np.asarray` on every
leaf); this module never sees a JAX array. Layer stacks stay stacked as
`[L, ...]`. Weights, biases and embeddings are cast once to the compute
dtype — bit-equivalent, because every use in the reference casts them
to the activation dtype first — while rmsnorm gains (`g`) stay f32, as
the reference applies them in f32.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from .configs.base import ModelConfig
from .models.common import compute_dtype, resolve_device


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig, device,
                    dtype: Optional[torch.dtype] = None):
    """Convert a numpy-leaved reference parameter tree. `dtype` defaults
    to the config's compute dtype."""
    dev = resolve_device(device)
    dt = compute_dtype(cfg.dtype) if dtype is None else dtype

    def convert(node, name: str):
        if isinstance(node, Mapping):
            return {k: convert(v, k) for k, v in node.items()}
        arr = np.asarray(node)
        t = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
        return t.to(device=dev, dtype=torch.float32 if name == "g" else dt)

    return convert(tree, "")
