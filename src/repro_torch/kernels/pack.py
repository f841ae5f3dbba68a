"""K5 — bit-plane pack: counterpart of `repro.kernels.pack`.

    planes[j, q, m] = OR_r (digit_j(u_r[r, q, m]) << g*r)

over pre-strided offset weights u_r [8/g, K8, M] uint8 (u_r[r, q, m] =
U[q*8/g + r, m]), giving planes [n_digits, K8, M] uint8 byte-identical
to `ref.pack_ref`. Packing runs once per weight matrix, at load
(`quant.bitplane.PimWeight.from_dense`). On CUDA tensors
`pack_bitplanes` launches the hand-written kernel of
`csrc/bitplane_pack.cu` and counts the launch in `LAUNCHES`; on CPU
tensors it runs the plain version `ref.pack_bitplanes_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref
from .paged_common import launch_kernel, ptr

#: kernel launches made by this process; only the CUDA launch below
#: increments it
LAUNCHES = 0

#: u_r, planes; K8, M, n_digits, group; stream
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def pack_bitplanes(u_r: torch.Tensor, n_bits: int, group: int = 1
                   ) -> torch.Tensor:
    """One K5 launch: u_r [8/g, K8, M] uint8 -> planes [n_d, K8, M]."""
    global LAUNCHES
    ref.check_dims(0, n_bits, group)
    if u_r.dim() != 3 or u_r.shape[0] != 8 // group:
        raise ValueError(f"bitplane_pack: u_r must be [{8 // group}, K8, M], "
                         f"got {tuple(u_r.shape)}")
    if u_r.dtype != torch.uint8:
        raise ValueError(f"bitplane_pack: u_r dtype {u_r.dtype} is not uint8")
    if u_r.device.type == "cpu":
        return ref.pack_bitplanes_ref(u_r, n_bits, group)
    if u_r.device.type != "cuda" or not u_r.is_contiguous():
        raise ValueError(f"bitplane_pack: u_r must be a contiguous CUDA "
                         f"tensor, got one on {u_r.device}")
    _, k8, m = u_r.shape
    nd = ref.n_digits(n_bits, group)
    planes = torch.empty((nd, k8, m), dtype=torch.uint8, device=u_r.device)
    if k8 and m:
        launch_kernel("bitplane_pack", "bitplane_pack_launch", _ARGTYPES, (
            ptr(u_r), ptr(planes), k8, m, nd, group,
        ), u_r.device)
        LAUNCHES += 1
    return planes
