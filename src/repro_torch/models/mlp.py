"""Feed-forward blocks: counterpart of `repro.models.mlp` — SwiGLU
(llama lineage) and the plain two-matrix MLP (granite's GELU MLP).

Each projection goes through `quant.pim_linear`, as in the reference: a
dense matmul in x's dtype for a dense weight, the bit-plane op for a
`PimWeight`. `impl` is the serving step's kernel impl, passed down to
`pim_linear` (the reference's blocks have no such argument). The
hidden activation carries the reference's ("batch", "seq", "ff") hook;
under tensor parallelism the up projections give each rank its d_ff
columns and the down projection's partial sums are all-reduced.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..dist.parallel import enter, row_linear, split_dim
from ..dist.sharding import shard
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


def _hidden(h: torch.Tensor, d_ff: Optional[int]) -> torch.Tensor:
    """The hidden activation's ("batch", "seq", "ff") hook. Under tensor
    parallelism `h` holds this rank's block of the `d_ff` columns where
    the up projections are split."""
    if d_ff is None:
        return h
    return shard(h, "batch", "seq", "ff", src_dim=split_dim(h, d_ff))


def swiglu(params: Params, x: torch.Tensor, act: str = "silu",
           impl: str = "auto", d_ff: Optional[int] = None):
    """`d_ff`: the whole hidden width, which tensor-parallel callers give
    (a rank's blocks do not tell it)."""
    x = enter(x)
    g = ACTS[act](pim_linear(x, params["w_gate"], impl))
    u = pim_linear(x, params["w_up"], impl)
    h = _hidden(g * u, d_ff)
    return row_linear(h, params["w_down"], d_ff or h.shape[-1], impl)


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
        impl: str = "auto", d_ff: Optional[int] = None):
    """`d_ff` as for `swiglu`."""
    h = _hidden(ACTS[act](pim_linear(enter(x), params["w_up"], impl)), d_ff)
    return row_linear(h, params["w_down"], d_ff or h.shape[-1], impl)
