"""Shared pieces of the two paged-attention kernels (K1 decode, K2
prefill): counterpart of `repro.kernels.paged_common`.

Host side only. The reference's device half (`double_buffered_page_walk`,
`load_kv_page`, the online-softmax refs) is TPU DMA machinery; the CUDA
sources re-express it once, in `csrc/paged_common.cuh`, for both kernels.

What lives here:
  * the int8 page codec (`quantize_pages`, `dequantize_pages`,
    `requantize_page_update`) — the only place page codes turn back into
    floats on the host side;
  * `check_quantized_operands`, the pool-dtype/scale pairing rule;
  * `bucketed_page_dispatch`, the gather/launch/scatter scaffold of the
    length-bucketed dispatch, and `bucket_scopes`, which names each of
    its bucket launches in the profiler timeline;
  * `check_kernel_operands` / `launch_kernel`, what both CUDA wrappers
    check and how they call into the built libraries.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
from typing import Callable, Dict, Optional, Sequence

import torch

from . import _build

NEG_INF = -1e30

#: symmetric int8 quantization ceiling — codes live in [-128, 127] and
#: each (page, head) plane's absmax maps to ±127
INT8_QMAX = 127.0

#: limits of the CUDA kernels (shared-memory tiles are sized from them)
MAX_HEAD_DIM = 256
MAX_BLOCK_SIZE = 64
MAX_GROUP = 16

#: dtype codes of the C interface (csrc/paged_common.cuh `DType`)
DTYPE_CODES: Dict[torch.dtype, int] = {
    torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
}
Q_DTYPES = (torch.float32, torch.bfloat16)


def quantize_pages(pages: torch.Tensor):
    """Per-page, per-head symmetric int8 quantization of KV pages.

    `pages` is float [..., bs, KV, hd]; returns `(codes int8 [..., bs,
    KV, hd], scales f32 [..., KV])` with `scale = absmax / 127` over
    each page's (bs, hd) plane per KV head. All-zero planes take scale
    1.0. `torch.round` rounds half to even, as the reference does."""
    f = pages.float()
    absmax = f.abs().amax(dim=(-3, -1))
    scales = torch.where(
        absmax > 0, absmax / INT8_QMAX, torch.ones_like(absmax)
    )
    codes = torch.clamp(
        torch.round(f / scales[..., None, :, None]),
        -(INT8_QMAX + 1), INT8_QMAX,
    ).to(torch.int8)
    return codes, scales


def dequantize_pages(codes: torch.Tensor, scales: torch.Tensor):
    """Inverse of `quantize_pages`: int8 codes [..., bs, KV, hd] times
    their per-(page, head) f32 scales [..., KV] -> f32 pages."""
    return codes.float() * scales[..., None, :, None]


def requantize_page_update(codes, scales, update_fn):
    """Read-modify-write on quantized pages: dequantize, apply
    `update_fn` on the float view (scatter new tokens in), requantize
    under the updated per-head absmax. Returns new `(codes, scales)`;
    the caller writes them back into the pools."""
    return quantize_pages(update_fn(dequantize_pages(codes, scales)))


def check_quantized_operands(k_pages, k_scales, v_scales) -> bool:
    """Validate the pool-dtype/scale pairing of one launch and return
    whether it is the quantized path: int8 pools MUST bring both scale
    arrays, float pools must bring none."""
    quantized = not k_pages.is_floating_point()
    if quantized and (k_scales is None or v_scales is None):
        raise ValueError(
            f"int8 KV pools (dtype {k_pages.dtype}) require k_scales and "
            "v_scales — quantized pages are meaningless without their "
            "per-page scale rows"
        )
    if not quantized and (k_scales is not None or v_scales is not None):
        raise ValueError(
            f"float KV pools (dtype {k_pages.dtype}) must not pass "
            "k_scales/v_scales — the scale operands only ride quantized "
            "pools"
        )
    return quantized


#: True while an annotated serve step runs (`serve.compiled`,
#: `annotate=True`): each bucket launch then runs inside a
#: `record_function` range; otherwise no range is opened at all
_BUCKET_SCOPES = contextvars.ContextVar("paged_bucket_scopes",
                                        default=False)


@contextlib.contextmanager
def bucket_scopes():
    """Name every bucket launch of the dispatches inside this block
    `paged_bucket_d{bound}x{count}` in the profiler timeline (the
    reference's per-bucket `named_scope`)."""
    token = _BUCKET_SCOPES.set(True)
    try:
        yield
    finally:
        _BUCKET_SCOPES.reset(token)


def bucketed_page_dispatch(
    launch: Callable, plan, perm: torch.Tensor, block_table: torch.Tensor,
    slot_operands: Sequence[torch.Tensor],
) -> torch.Tensor:
    """One kernel launch per occupancy bucket, each bounded at the
    bucket's walk depth.

    `launch(depth, bt_rows, *operand_rows) -> [count, ...]` runs one
    bucket; `plan`/`perm` come from `ops.make_bucket_plan`. A dummy
    all-zero row is appended to every gathered array — padding entries
    of `perm` point at it (zero table = scratch page, zero length =
    fully masked) and their outputs land on the dummy output row, which
    is dropped; that row is the only index the final scatter writes
    more than once. Real slots appear exactly once in `perm`.

    The pages a bucket's bound cuts off are fully masked for every valid
    row and fold as exact no-ops, so the bucketed output is
    bit-identical to the single launch on every valid row. Inside
    `bucket_scopes()` each launch is a `paged_bucket_d{bound}x{count}`
    profiler range."""
    b = block_table.shape[0]
    bt_ext = torch.cat([block_table, torch.zeros_like(block_table[:1])])
    ops_ext = [torch.cat([o, torch.zeros_like(o[:1])]) for o in slot_operands]
    outs, off = [], 0
    for bound, count in plan:
        idx = perm[off: off + count]
        with (torch.profiler.record_function(f"paged_bucket_d{bound}x{count}")
              if _BUCKET_SCOPES.get() else contextlib.nullcontext()):
            outs.append(
                launch(bound, bt_ext[idx], *[o[idx] for o in ops_ext])
            )
        off += count
    res = torch.cat(outs)
    out_full = res.new_zeros((b + 1,) + tuple(res.shape[1:]))
    out_full[perm] = res
    return out_full[:b]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_kernel_operands(
    name: str,
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scales: Optional[torch.Tensor],
    v_scales: Optional[torch.Tensor],
    block_table: torch.Tensor,
    slot_vectors: Dict[str, Optional[torch.Tensor]],
) -> None:
    """What both CUDA wrappers check before a launch: device, dtype,
    shape and contiguity of every operand, and the kernels' size limits
    (hd <= 256, bs <= 64, GQA group <= 16)."""
    dev = q.device
    _require(dev.type == "cuda", f"{name}: q lies on {dev}, not a CUDA device")
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_table": block_table, "k_scales": k_scales,
               "v_scales": v_scales, **slot_vectors}
    for key, t in tensors.items():
        if t is None:
            continue
        _require(t.device == dev,
                 f"{name}: {key} lies on {t.device}, q on {dev}")
        _require(t.is_contiguous(), f"{name}: {key} must be contiguous")
    _require(q.dtype in Q_DTYPES,
             f"{name}: q dtype {q.dtype} not in {Q_DTYPES}")
    _require(k_pages.dtype in DTYPE_CODES and v_pages.dtype == k_pages.dtype,
             f"{name}: pool dtypes {k_pages.dtype}/{v_pages.dtype} must "
             "match and be one of bfloat16, float32, int8")
    _require(k_pages.dim() == 4 and v_pages.shape == k_pages.shape,
             f"{name}: pools must be [n_blocks, bs, KV, hd], got "
             f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    n_blocks, bs, n_kv, hd = k_pages.shape
    h = q.shape[-2]
    _require(q.shape[-1] == hd, f"{name}: q head dim {q.shape[-1]} != {hd}")
    _require(h % n_kv == 0, f"{name}: {h} heads not a multiple of {n_kv}")
    _require(hd <= MAX_HEAD_DIM, f"{name}: hd={hd} > {MAX_HEAD_DIM}")
    _require(bs <= MAX_BLOCK_SIZE, f"{name}: bs={bs} > {MAX_BLOCK_SIZE}")
    _require(h // n_kv <= MAX_GROUP,
             f"{name}: GQA group {h // n_kv} > {MAX_GROUP}")
    if k_scales is not None:
        for key, s in (("k_scales", k_scales), ("v_scales", v_scales)):
            _require(s.dtype == torch.float32 and
                     tuple(s.shape) == (n_blocks, n_kv),
                     f"{name}: {key} must be f32 [{n_blocks}, {n_kv}], got "
                     f"{s.dtype} {tuple(s.shape)}")
    b = q.shape[0]
    _require(block_table.dtype == torch.int32 and block_table.dim() == 2
             and block_table.shape[0] == b,
             f"{name}: block_table must be int32 [{b}, mb], got "
             f"{block_table.dtype} {tuple(block_table.shape)}")
    for key, t in slot_vectors.items():
        if t is not None:
            _require(t.dtype == torch.int32 and tuple(t.shape) == (b,),
                     f"{name}: {key} must be int32 [{b}], got "
                     f"{t.dtype} {tuple(t.shape)}")


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """Device pointer of `t` for the C interface (NULL for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def launch_kernel(lib_name: str, symbol: str, argtypes, args,
                  device: torch.device) -> None:
    """Call one C launch entry of a built kernel library on the current
    stream of `device`; raise if it reports a CUDA error. The kernels
    allocate nothing and do not synchronise."""
    fn = _build.load_function(lib_name, symbol, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"{symbol}: CUDA error {rc} at launch"
        )
