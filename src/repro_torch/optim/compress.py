"""Error-feedback int8 gradient compression for the cross-pod
all-reduce: counterpart of `repro.optim.compress`.

The `pod` axis is the slow boundary (DCN-ish); compressing the DP gradient
reduction over it trades 4x fewer bytes for quantization noise, with an
error-feedback residual so the bias vanishes over steps (1-bit-Adam /
EF-SGD lineage). Applied ONLY to the pod axis — intra-pod reductions stay
full precision.

compress -> all_reduce(int8-sum in int32) -> decompress, with the residual
carried in f32 alongside the optimizer state. Each rank calls
`compressed_psum` on its own gradients, where the reference runs it
inside `shard_map`; the collectives go over `axis` of the mesh given, or
of the active sharding context's.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..dist import collectives
from .adamw import tree_map

Params = Any


def init_residual(grads: Params) -> Params:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    absmax = torch.max(torch.abs(x))
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def shared_codes(gf: torch.Tensor, axis: str, mesh=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of `gf` under the scale every rank along `axis` shares:
    the pmax of the per-shard absmax (a scalar — negligible traffic), so
    the summed int8 payloads decompress exactly."""
    absmax = collectives.pmax(torch.max(torch.abs(gf)), axis, mesh)
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(grads: Params, residual: Params, axis: str, mesh=None
                    ) -> Tuple[Params, Params]:
    """All-reduce `grads` over `axis` with int8 error-feedback
    compression. Returns (mean grads, new residual)."""
    n = collectives._mesh(mesh).axis_size(axis)

    def one(g, r):
        gf = g.float() + r
        q, scale = shared_codes(gf, axis, mesh)
        new_r = gf - q.float() * scale  # local error feedback
        # int8 payload, int32 sum
        q_sum = collectives.all_reduce(q.to(torch.int32), axis, mesh)
        approx = q_sum.float() * scale
        return (approx / n).to(g.dtype), new_r

    def walk(g, r):
        if isinstance(g, dict):
            pairs = {k: walk(g[k], r[k]) for k in g}
            return ({k: p[0] for k, p in pairs.items()},
                    {k: p[1] for k, p in pairs.items()})
        return one(g, r)

    return walk(grads, residual)


def compression_ratio(dtype=torch.bfloat16) -> float:
    return dtype.itemsize / torch.int8.itemsize
