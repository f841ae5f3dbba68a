"""K3 — bit-plane GEMV: counterpart of `repro.kernels.bitplane_gemv`.

`bitplane_gemv(x_r, planes, n_bits=, group=)` returns the raw f32
contraction [B, M] = x @ U over packed digit planes, U being the
unsigned offset form they store (`kernels/ref.py`); the caller
(`ops.bitplane_matmul`) applies the `2^(n-1) * sum(x)` offset and the
per-channel scale. On CUDA tensors it launches the hand-written kernel
of `csrc/bitplane_gemv.cu` (built at first use) and counts the launch
in `LAUNCHES`; on CPU tensors — and only there — it runs the plain
version `ref.bitplane_raw_ref`.

Layouts (the reference's):
    x_r     [8/g, B, K8]        bf16 / f32, x_r[r, b, q] = x[b, q*8/g + r]
    planes  [n_digits, K8, M]   uint8, K8 = K*g/8
    out     [B, M]              f32

The reference kernel needs K8 and M to be multiples of its TPU blocks
(128 and 256), so it refuses qwen2-1.5b's K8 = 192 and 1120; this one
takes any K8, M and B and masks the edges itself.

The kernel tiles the output in 32 columns of M by up to 64 rows of B
and walks K in chunks of 64 unpacked rows; `gemv_splits` cuts K into
ranges of whole chunks so that even a narrow or short projection puts
enough blocks on the card. Each range writes an f32 partial into
scratch and a second pass adds them in order. The split depends on K8,
M and g only, never on B, so a row's result does not depend on how many
rows share its launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref
from .paged_common import DTYPE_CODES, Q_DTYPES, launch_kernel, ptr

#: kernel launches made by this process (the main-path evidence
#: `chip_smoke.py` reads); only the CUDA launch below increments it
LAUNCHES = 0

#: the kernel's output tile along M and the unpacked K rows of one chunk
#: (csrc/bitplane_gemv.cu kGemvTileM, kGemvChunkK)
TILE_M = 32
CHUNK_K = 64
#: blocks a launch of up to 64 rows aims for: four of the kernel's small
#: (2-warp) blocks on each of the H100's 132 SMs, so that enough plane
#: loads are in flight to stream at the memory's rate
TARGET_BLOCKS = 4 * 132

#: x_r, planes, out, partial; x dtype, B, K8, M, n_digits, group,
#: splits; stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def gemv_splits(k8: int, m: int, group: int) -> int:
    """Number of K ranges for a [K8 packed rows -> M] projection: as many
    as bring the column tiles times the splits to about `TARGET_BLOCKS`,
    each range whole chunks and none empty. A function of the weight's
    shape alone."""
    n_chunks = -(-k8 // (CHUNK_K * group // 8))
    want = min(-(-TARGET_BLOCKS // -(-m // TILE_M)), n_chunks)
    if want <= 1:
        return 1
    return -(-n_chunks // -(-n_chunks // want))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_raw_operands(name: str, x_r: torch.Tensor, planes: torch.Tensor,
                       n_bits: int, group: int) -> None:
    """What K3 and K4 check before any launch: the bit-plane format
    (2 <= n_bits <= 8, g in {1, 2, 4}) and the operands' shapes and
    dtypes; on a CUDA tensor also device and contiguity."""
    ref.check_dims(0, n_bits, group)
    _require(x_r.dim() == 3 and x_r.shape[0] == 8 // group,
             f"{name}: x_r must be [{8 // group}, B, K8], got "
             f"{tuple(x_r.shape)}")
    nd = ref.n_digits(n_bits, group)
    _require(planes.dim() == 3 and planes.shape[0] == nd
             and planes.shape[1] == x_r.shape[2],
             f"{name}: planes must be [{nd}, {x_r.shape[2]}, M], got "
             f"{tuple(planes.shape)}")
    _require(planes.dtype == torch.uint8,
             f"{name}: planes dtype {planes.dtype} is not uint8")
    _require(x_r.dtype in Q_DTYPES,
             f"{name}: x_r dtype {x_r.dtype} not in {Q_DTYPES}")
    if x_r.device.type == "cpu":
        return
    _require(x_r.device.type == "cuda",
             f"{name}: x_r lies on {x_r.device}, not a CUDA device")
    _require(planes.device == x_r.device,
             f"{name}: planes lie on {planes.device}, x_r on {x_r.device}")
    _require(x_r.is_contiguous() and planes.is_contiguous(),
             f"{name}: x_r and planes must be contiguous")


def bitplane_gemv(x_r: torch.Tensor, planes: torch.Tensor, *, n_bits: int,
                  group: int = 1) -> torch.Tensor:
    """One K3 launch: raw f32 [B, M] = x @ U."""
    global LAUNCHES
    check_raw_operands("bitplane_gemv", x_r, planes, n_bits, group)
    if x_r.device.type == "cpu":
        return ref.bitplane_raw_ref(x_r, planes, group)
    _, b, k8 = x_r.shape
    m = planes.shape[2]
    out = torch.empty((b, m), dtype=torch.float32, device=x_r.device)
    if not (b and m):
        return out
    splits = gemv_splits(k8, m, group)
    partial = (torch.empty((splits, b, m), dtype=torch.float32,
                           device=x_r.device) if splits > 1 else None)
    launch_kernel("bitplane_gemv", "bitplane_gemv_launch", _ARGTYPES, (
        ptr(x_r), ptr(planes), ptr(out), ptr(partial),
        DTYPE_CODES[x_r.dtype], b, k8, m, ref.n_digits(n_bits, group), group,
        splits,
    ), x_r.device)
    LAUNCHES += 1
    return out
