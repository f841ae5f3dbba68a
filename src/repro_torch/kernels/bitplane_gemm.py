"""K4 — bit-plane GEMM: counterpart of `repro.kernels.bitplane_gemm`.

The same raw contraction as K3 (`bitplane_gemv`), f32 [B, M] = x @ U,
for the tall activations of a prefill: `ops.bitplane_matmul` takes it
when B > 512. On CUDA tensors it launches the hand-written kernel of
`csrc/bitplane_gemm.cu` and counts the launch in `LAUNCHES`; on CPU
tensors it runs the plain version `ref.bitplane_raw_ref`. Layouts and
operand checks are K3's.
"""

from __future__ import annotations

import torch

from . import ref
from .bitplane_gemv import check_raw_operands, launch_raw

#: kernel launches made by this process; only the CUDA launch below
#: increments it
LAUNCHES = 0


def bitplane_gemm(x_r: torch.Tensor, planes: torch.Tensor, *, n_bits: int,
                  group: int = 1) -> torch.Tensor:
    """One K4 launch: raw f32 [B, M] = x @ U."""
    global LAUNCHES
    check_raw_operands("bitplane_gemm", x_r, planes, n_bits, group)
    if x_r.device.type == "cpu":
        return ref.bitplane_raw_ref(x_r, planes, group)
    out, launched = launch_raw("bitplane_gemm", x_r, planes, n_bits, group)
    LAUNCHES += launched
    return out
