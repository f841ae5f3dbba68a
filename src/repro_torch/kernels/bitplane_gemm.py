"""K4 — bit-plane GEMM: counterpart of `repro.kernels.bitplane_gemm`.

The same raw contraction as K3 (`bitplane_gemv`), f32 [B, M] = x @ U,
for the tall activations of a prefill: `ops.bitplane_matmul` takes it
when B > 512. On CUDA tensors it launches the hand-written tensor-core
kernel of `csrc/bitplane_gemm.cu` and counts the launch in `LAUNCHES`;
on CPU tensors it runs the plain version `ref.bitplane_raw_ref`.
Layouts and operand checks are K3's.

The kernel tiles the output in 128 x 128 blocks and walks K in pairs of
chunks, 128 unpacked rows a pair. Where that leaves too few blocks to
fill the card (narrow M, long K), `gemm_splits` cuts K into ranges of
whole pairs; each range writes an f32 partial into scratch and a second
pass adds them in order. The split depends on K8, M and g only, never on
B, so a row's result does not depend on how many rows share its launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref
from .bitplane_gemv import check_raw_operands
from .paged_common import DTYPE_CODES, launch_kernel, ptr

#: kernel launches made by this process; only the CUDA launch below
#: increments it
LAUNCHES = 0

#: the kernel's output tile along M, and the unpacked K rows of one
#: pair of chunks (csrc/bitplane_gemm.cu kGemmTileM, Pair)
TILE_M = 128
PAIR_K = 128
#: most column tiles x K splits a launch takes: with the 6 row tiles of a
#: 768-row prefill, 264 blocks, one wave of two blocks on each of the
#: H100's 132 SMs (one block decodes while the other multiplies)
MAX_TILES = 44

#: x_r, planes, out, partial; x dtype, B, K8, M, n_digits, group,
#: splits; stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def gemm_splits(k8: int, m: int, group: int) -> int:
    """Number of K ranges for a [K8 packed rows -> M] projection: as many
    as keep the column tiles times the splits within `MAX_TILES`, each
    range whole pairs of chunks and none empty. A function of the
    weight's shape alone."""
    n_pairs = _ceil_div(k8, PAIR_K * group // 8)
    want = min(MAX_TILES // _ceil_div(m, TILE_M), n_pairs)
    if want <= 1:
        return 1
    return _ceil_div(n_pairs, _ceil_div(n_pairs, want))


def bitplane_gemm(x_r: torch.Tensor, planes: torch.Tensor, *, n_bits: int,
                  group: int = 1) -> torch.Tensor:
    """One K4 launch: raw f32 [B, M] = x @ U."""
    global LAUNCHES
    check_raw_operands("bitplane_gemm", x_r, planes, n_bits, group)
    if x_r.device.type == "cpu":
        return ref.bitplane_raw_ref(x_r, planes, group)
    _, b, k8 = x_r.shape
    m = planes.shape[2]
    out = torch.empty((b, m), dtype=torch.float32, device=x_r.device)
    if not (b and m):
        return out
    splits = gemm_splits(k8, m, group)
    partial = (torch.empty((splits, b, m), dtype=torch.float32,
                           device=x_r.device) if splits > 1 else None)
    launch_kernel("bitplane_gemm", "bitplane_gemm_launch", _ARGTYPES, (
        ptr(x_r), ptr(planes), ptr(out), ptr(partial),
        DTYPE_CODES[x_r.dtype], b, k8, m, ref.n_digits(n_bits, group), group,
        splits,
    ), x_r.device)
    LAUNCHES += 1
    return out
