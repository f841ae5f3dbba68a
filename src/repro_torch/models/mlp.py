"""Feed-forward blocks: counterpart of `repro.models.mlp` — SwiGLU
(llama lineage) and the plain two-matrix MLP (granite's GELU MLP).

Each projection goes through `quant.pim_linear`, as in the reference: a
dense matmul in x's dtype for a dense weight, the bit-plane op for a
`PimWeight`. `impl` is the serving step's kernel impl, passed down to
`pim_linear` (the reference's blocks have no such argument).
"""

from __future__ import annotations

import torch

from ..quant.bitplane import pim_linear
from .common import ACTS, Params, dense_init


def init_swiglu(d_model: int, d_ff: int, generator, device,
                dtype=torch.float32, out=None) -> Params:
    """`out`: preallocated leaves to fill instead of new tensors."""
    def o(name):
        return None if out is None else out[name]
    return {
        "w_gate": dense_init(d_model, d_ff, generator, device, dtype,
                             o("w_gate")),
        "w_up": dense_init(d_model, d_ff, generator, device, dtype, o("w_up")),
        "w_down": dense_init(d_ff, d_model, generator, device, dtype,
                             o("w_down")),
    }


def swiglu(params: Params, x: torch.Tensor, act: str = "silu",
           impl: str = "auto"):
    g = ACTS[act](pim_linear(x, params["w_gate"], impl))
    u = pim_linear(x, params["w_up"], impl)
    return pim_linear(g * u, params["w_down"], impl)


def init_mlp(d_model: int, d_ff: int, generator, device,
             dtype=torch.float32, out=None) -> Params:
    """The plain MLP's two projections, drawn up then down."""
    def o(name):
        return None if out is None else out[name]
    return {
        "w_up": dense_init(d_model, d_ff, generator, device, dtype, o("w_up")),
        "w_down": dense_init(d_ff, d_model, generator, device, dtype,
                             o("w_down")),
    }


def mlp(params: Params, x: torch.Tensor, act: str = "gelu",
        impl: str = "auto"):
    h = ACTS[act](pim_linear(x, params["w_up"], impl))
    return pim_linear(h, params["w_down"], impl)
