"""K1 — paged decode attention: counterpart of
`repro.kernels.paged_attention`.

One query token per slot attends over that slot's KV pages, addressed
through its block-table row, so slots of different lengths decode in
one launch. `paged_decode_attention` is the kernel wrapper: on CUDA
tensors it launches the hand-written kernel of `csrc/paged_decode.cu`
(built at first use) and counts the launch in `LAUNCHES`; on CPU
tensors — and only there — it runs the plain version `ref.
paged_attention_ref` over the same walk. On the card the walk is split
into ranges (`decode_ranges`), one block each, whose softmax states the
kernel merges in order through scratch that the wrapper allocates.

Layouts (the reference's):
    q            [B, H, hd]              one query token per slot
    k/v_pages    [n_blocks, bs, KV, hd]  bf16 / f32, or int8 codes with
                                         k/v_scales [n_blocks, KV] f32
    block_table  [B, max_blocks] int32   page id of slot b's j-th page
    lengths      [B] int32               valid kv count (ragged)
    window       int                     sliding window (capacity = full)
    out          [B, H, hd] f32
"""

from __future__ import annotations

import ctypes

import torch

from . import ref, work
from .ops import resolve_impl
from .paged_common import (
    DTYPE_CODES,
    bucketed_page_dispatch,
    check_kernel_operands,
    check_quantized_operands,
    launch_kernel,
    ptr,
)

#: kernel launches made by this process (the main-path evidence
#: `chip_smoke.py` reads); only the CUDA launch below increments it
LAUNCHES = 0

_ARGTYPES = (
    [ctypes.c_void_p] * 11           # q, k/v pools, k/v scales, table,
                                     # lengths, block_start, out,
                                     # part_acc, part_ml
    + [ctypes.c_int] * 12            # q/kv dtype, B, H, KV, hd, bs, mb,
                                     # depth, window, n_ranges,
                                     # range_chunks
    + [ctypes.c_float, ctypes.c_void_p]   # scale, stream
)

#: keys a fold step takes (csrc/paged_decode.cu kDecodeKeys)
CHUNK_KEYS = 16
#: walk chunks per range: two for each of a block's four warps
RANGE_CHUNKS = 8


def decode_ranges(mb: int, bs: int):
    """`(count, chunks)`: the kernel splits the page walk into `count`
    ranges of `chunks` chunks (16 keys each; a page is ceil(bs/16)
    chunks), one block per (slot, kv-head, tile of 16 query heads,
    range), and merges the ranges' softmax states in order. At the main
    path's 68-column table
    that is 9 ranges, 144 blocks for 8 slots. A function of the table's
    width and the page size only, so every launch of a serving run —
    bucketed, depth-bounded or not — splits at the same table positions
    and a valid row's output never depends on how rows are bucketed."""
    n_chunks = mb * -(-bs // CHUNK_KEYS)
    return -(-n_chunks // RANGE_CHUNKS), RANGE_CHUNKS


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    window: int,
    *,
    k_scales=None,
    v_scales=None,
    block_start=None,
    depth=None,
) -> torch.Tensor:
    """One K1 launch; f32 [B, H, hd].

    `depth` bounds the walk to table columns `[s, s + depth)` with
    `s = max(min(block_start, mb - depth), 0)` (`block_start` defaults
    to zeros, `depth` to the table width). `k_scales`/`v_scales` are
    required iff the pools are int8; the kernel multiplies the codes'
    dot products by the page's k scale and the probabilities by its v
    scale, which equals dequantizing every code."""
    global LAUNCHES
    check_quantized_operands(k_pages, k_scales, v_scales)
    b, h, hd = q.shape
    mb = block_table.shape[1]
    depth = mb if depth is None else int(depth)
    if not 1 <= depth <= mb:
        raise ValueError(f"depth {depth} outside [1, {mb}]")
    if q.device.type == "cpu":
        return ref.paged_attention_ref(
            q, k_pages, v_pages, block_table, lengths, window,
            k_scales=k_scales, v_scales=v_scales,
            block_start=block_start, depth=depth,
        )
    check_kernel_operands(
        "paged_decode", q, k_pages, v_pages, k_scales, v_scales,
        block_table, {"lengths": lengths, "block_start": block_start},
    )
    out = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    _, bs, n_kv, _ = k_pages.shape
    n_ranges, range_chunks = decode_ranges(mb, bs)
    part_acc = part_ml = None
    if n_ranges > 1:
        part_acc = torch.empty((n_ranges, b, h, hd), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((n_ranges, b, h, 2), dtype=torch.float32,
                              device=q.device)
    launch_kernel("paged_decode", "paged_decode_launch", _ARGTYPES, (
        ptr(q), ptr(k_pages), ptr(v_pages), ptr(k_scales), ptr(v_scales),
        ptr(block_table), ptr(lengths), ptr(block_start), ptr(out),
        ptr(part_acc), ptr(part_ml), DTYPE_CODES[q.dtype],
        DTYPE_CODES[k_pages.dtype], b, h, n_kv, hd, bs, mb, depth,
        int(window), n_ranges, range_chunks, float(hd ** -0.5),
    ), q.device)
    LAUNCHES += 1
    return out


def paged_decode_attention_bucketed(
    q, k_pages, v_pages, block_table, lengths, window, plan, perm, *,
    k_scales=None, v_scales=None, block_start=None,
) -> torch.Tensor:
    """One `paged_decode_attention` launch per occupancy bucket, each
    bounded at the bucket's walk depth, rows gathered and scattered
    through `perm`. Bit-identical to the single launch on every slot
    with length >= 1."""
    if block_start is None:
        block_start = torch.zeros_like(lengths)

    def launch(bound, bt_rows, q_rows, len_rows, start_rows):
        return paged_decode_attention(
            q_rows, k_pages, v_pages, bt_rows, len_rows, window,
            k_scales=k_scales, v_scales=v_scales,
            block_start=start_rows, depth=bound,
        )

    return bucketed_page_dispatch(
        launch, plan, perm, block_table, [q, lengths, block_start],
    )


def paged_attention(
    q, k_pages, v_pages, block_table, lengths, window, *,
    impl: str = "auto", k_scales=None, v_scales=None, plan=None,
    perm=None, block_start=None,
) -> torch.Tensor:
    """Impl dispatch (`ops.resolve_impl`): `ref` runs the plain version
    over the whole table (plans and `block_start` do not change its
    valid rows); `cuda` — or `auto` on CUDA tensors — launches the
    kernel, bucketed when `plan` is given. Either route reports the
    same work (`work.decode_work`) to a listening meter."""
    check_quantized_operands(k_pages, k_scales, v_scales)
    with work.dispatch("paged_decode", lambda: work.decode_work(
            q, k_pages, block_table, lengths, window, k_scales,
            block_start)):
        if resolve_impl(impl, q.device) == "ref":
            return ref.paged_attention_ref(
                q, k_pages, v_pages, block_table, lengths, window,
                k_scales=k_scales, v_scales=v_scales,
            )
        if plan is not None:
            return paged_decode_attention_bucketed(
                q, k_pages, v_pages, block_table, lengths, window, plan,
                perm, k_scales=k_scales, v_scales=v_scales,
                block_start=block_start,
            )
        return paged_decode_attention(
            q, k_pages, v_pages, block_table, lengths, window,
            k_scales=k_scales, v_scales=v_scales, block_start=block_start,
        )
