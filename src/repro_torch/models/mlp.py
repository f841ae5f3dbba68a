"""SwiGLU feed-forward block: counterpart of `repro.models.mlp.swiglu`.

The reference routes each projection through `quant.pim_linear`, which
is a dense matmul for dense weights (`--quantize` is not ported yet), so
here each projection is `x @ w` in x's dtype.
"""

from __future__ import annotations

import torch

from .common import ACTS, Params, dense_init


def init_swiglu(d_model: int, d_ff: int, generator, device,
                dtype=torch.float32) -> Params:
    return {
        "w_gate": dense_init(d_model, d_ff, generator, device, dtype),
        "w_up": dense_init(d_model, d_ff, generator, device, dtype),
        "w_down": dense_init(d_ff, d_model, generator, device, dtype),
    }


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense projection in x's dtype (the reference's `pim_linear` on a
    dense weight)."""
    return x @ w.to(x.dtype)


def swiglu(params: Params, x: torch.Tensor, act: str = "silu"):
    g = ACTS[act](linear(x, params["w_gate"]))
    u = linear(x, params["w_up"])
    return linear(g * u, params["w_down"])
