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

The kernel walks K in chunks of 64 unpacked rows; `gemv_splits` cuts K
into ranges of whole chunks so that even a narrow or short projection
puts enough blocks on the card. Each range writes an f32 partial into
scratch and a second pass adds them in order. The split depends on K8,
M and g only, never on B. A launch takes one of two tiles
(`wide_tile`, a function of B alone): the narrow one, 32 columns of M by
up to 64 rows of B a block on mma.sync, for up to 24 rows; the wide
one, 64 columns by 128 rows a block on wgmma, above (a decode of 128
slots fetches and decodes each plane chunk once per column tile). Both
give a row the same bits, so a row's result does not depend on how many
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
#: those of them that took the wide tile (`wide_tile`); a decode graph's
#: replay adds its captured wide launches here as it does to `LAUNCHES`
#: (serve/graphs.py)
LAUNCHES_WIDE = 0

#: the narrow tile's columns of M and the unpacked K rows of one chunk
#: (csrc/bitplane_gemv_tile.cuh kGemvTileM, kGemvChunkK)
TILE_M = 32
CHUNK_K = 64
#: the wide tile's rows a block (kWideTB)
WIDE_TILE_B = 128
#: the most rows a launch gives the narrow tile
NARROW_MAX_B = 24
#: blocks a launch of up to 64 rows aims for: four of the kernel's small
#: (2-warp) blocks on each of the H100's 132 SMs, so that enough plane
#: loads are in flight to stream at the memory's rate
TARGET_BLOCKS = 4 * 132

#: x_r, planes, out, partial, xt; xt's elements; x dtype, B, K8, M,
#: n_digits, group, splits, wide; stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
             + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def wide_tile(b: int) -> bool:
    """Whether a launch of B rows takes the wide tile (128 rows x 64
    columns a block, on wgmma) rather than the narrow one (up to 64 x 32,
    on mma.sync): above `NARROW_MAX_B` rows. The narrow tile's time grows
    with B and the wide one's hardly does; on an H100 they cross between
    24 and 32 rows on granite-20b's projections (PERF.md, the kernel
    table). A function of B alone; both tiles give every row the same
    bits. The known cost: on a narrow projection (granite's k / v,
    [6144 -> 128]) the wide tile is slightly slower at 128 rows, and f32
    x at 32 rows."""
    return b > NARROW_MAX_B


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


def wide_x_elements(dtype: torch.dtype, b: int, k8: int, group: int) -> int:
    """bf16 elements of the wide tile's x scratch (csrc/bitplane_gemv.cu,
    `xt`): per bf16 term of x (3 for f32 x), its ceil(K8 / 8g) chunks of
    64 k for B rows rounded up to 128. The launch passes the size it
    allocated, and the C side refuses one below its own reckoning."""
    terms = 1 if dtype == torch.bfloat16 else 3
    chunks = -(-k8 // (CHUNK_K * group // 8))
    return terms * chunks * -(-b // WIDE_TILE_B) * WIDE_TILE_B * CHUNK_K


def bitplane_gemv(x_r: torch.Tensor, planes: torch.Tensor, *, n_bits: int,
                  group: int = 1) -> torch.Tensor:
    """One K3 launch: raw f32 [B, M] = x @ U."""
    global LAUNCHES, LAUNCHES_WIDE
    check_raw_operands("bitplane_gemv", x_r, planes, n_bits, group)
    if x_r.device.type == "cpu":
        return ref.bitplane_raw_ref(x_r, planes, group)
    _, b, k8 = x_r.shape
    m = planes.shape[2]
    out = torch.empty((b, m), dtype=torch.float32, device=x_r.device)
    if not (b and m):
        return out
    splits = gemv_splits(k8, m, group)
    wide = wide_tile(b)
    partial = (torch.empty((splits, b, m), dtype=torch.float32,
                           device=x_r.device) if splits > 1 else None)
    xt = (torch.empty(wide_x_elements(x_r.dtype, b, k8, group),
                      dtype=torch.bfloat16, device=x_r.device)
          if wide else None)
    launch_kernel("bitplane_gemv", "bitplane_gemv_launch", _ARGTYPES, (
        ptr(x_r), ptr(planes), ptr(out), ptr(partial), ptr(xt),
        0 if xt is None else xt.numel(), DTYPE_CODES[x_r.dtype], b, k8, m, ref.n_digits(n_bits, group), group,
        splits, int(wide),
    ), x_r.device)
    LAUNCHES += 1
    LAUNCHES_WIDE += wide
    return out
