"""K6 — grouped bit-plane GEMV: K3 over an expert-sorted row list.

`bitplane_grouped(x_r, planes, offsets, n_bits=, group=)` returns the raw
f32 contraction [P, M]: row p times the offset form U_e of expert e's
planes, where rows [offsets[e], offsets[e+1]) belong to expert e. The
caller (`ops.bitplane_grouped_matmul`) applies the `2^(n-1) * sum(x)`
offset and each expert's per-channel scale. On CUDA tensors it launches
the hand-written kernel of `csrc/bitplane_grouped.cu` (built at first
use) and counts the launch in `LAUNCHES`; on CPU tensors — and only
there — it runs the plain version `bitplane_grouped_ref` (every expert
over every row, each row keeping its own expert's).

Layouts:
    x_r      [8/g, P, K8]           bf16 / f32, rows sorted by expert
    planes   [E, n_digits, K8, M]   uint8, a stacked expert `PimWeight`
    offsets  [E + 1]                int32 on x_r's device, 0 .. P
    out      [P, M]                 f32

It replaces no TPU kernel: the reference `vmap`s `bitplane_matmul` over
a capacity-routed expert stack. The dropless routing of `models.moe`
gives the experts ragged row counts held on the device, so a launch per
expert would need them on the host; K6 reads them in the kernel, its
grid fixed by P, E, K8 and M, so a CUDA graph replays it. Like K3 it is
bound by the plane bytes at decode (about P / E rows an expert), by the
tensor cores at a long prefill. It uses K3's tile and `gemv_splits`'s K
ranges, each CTA adding the ranges' sums in order where K3 writes
partials for a second kernel to add, so each row equals K3's result on
its expert's planes bit for bit (`csrc/bitplane_grouped.cu`).
"""

from __future__ import annotations

import ctypes

import torch

from . import ref
from .bitplane_gemv import check_raw_operands, gemv_splits
from .paged_common import DTYPE_CODES, launch_kernel, ptr

#: kernel launches made by this process (`chip_smoke.py` reads it); only
#: the CUDA launch below increments it
LAUNCHES = 0

#: x_r, planes, offsets, out; x dtype, P, K8, M, n_digits, group, E,
#: splits; stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def bitplane_grouped_ref(x_r: torch.Tensor, planes: torch.Tensor,
                         offsets: torch.Tensor, group: int = 1
                         ) -> torch.Tensor:
    """Plain K6: K3's plain version on every expert's planes over every
    row, each row keeping its own expert's (`ref.every_expert_ref`, E
    times the work). A row's expert comes from the offsets on the
    device, so it runs on either device and reads nothing on the
    host."""
    p = x_r.shape[1]
    expert = torch.searchsorted(
        offsets[1:], torch.arange(p, dtype=offsets.dtype,
                                  device=offsets.device), right=True)
    return ref.every_expert_ref(
        expert, planes.shape[0],
        lambda e: ref.bitplane_raw_ref(x_r, planes[e], group))


def bitplane_grouped(x_r: torch.Tensor, planes: torch.Tensor,
                     offsets: torch.Tensor, *, n_bits: int,
                     group: int = 1) -> torch.Tensor:
    """One K6 launch: raw f32 [P, M]."""
    global LAUNCHES
    if planes.dim() != 4:
        raise ValueError("bitplane_grouped: planes must be "
                         f"[E, n_digits, K8, M], got {tuple(planes.shape)}")
    check_raw_operands("bitplane_grouped", x_r, planes[0], n_bits, group)
    e = planes.shape[0]
    if offsets.shape != (e + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"bitplane_grouped: offsets must be int32 [{e + 1}]"
                         f", got {offsets.dtype} {tuple(offsets.shape)}")
    if x_r.device.type == "cpu":
        return bitplane_grouped_ref(x_r, planes, offsets, group)
    if not (offsets.device.type == "cuda" and offsets.device == x_r.device
            and offsets.is_contiguous()):
        raise ValueError("bitplane_grouped: offsets must lie contiguous on "
                         f"x_r's device {x_r.device}, not {offsets.device}")
    _, p, k8 = x_r.shape
    m = planes.shape[-1]
    out = torch.empty((p, m), dtype=torch.float32, device=x_r.device)
    if not (p and m):
        return out
    launch_kernel("bitplane_grouped", "bitplane_grouped_launch", _ARGTYPES, (
        ptr(x_r), ptr(planes), ptr(offsets), ptr(out),
        DTYPE_CODES[x_r.dtype], p, k8, m, ref.n_digits(n_bits, group), group,
        e, gemv_splits(k8, m, group),
    ), x_r.device)
    LAUNCHES += 1
    return out
