"""K2 — paged prefill attention: counterpart of
`repro.kernels.paged_prefill`.

T suffix queries per slot attend, through the block table, over the
cached-prefix pages and the fresh suffix — suffix row t sits at logical
position `start + t` and sees

    kv_pos <= start + t          (causality, offset by the cached prefix)
    kv_pos <  total              (suffix padding rows hold garbage KV)
    kv_pos >  start + t - window (sliding window)

`paged_prefill_attention` is the kernel wrapper: on CUDA tensors it
launches the hand-written kernel of `csrc/paged_prefill.cu` and counts
the launch in `LAUNCHES`; on CPU tensors — and only there — it runs the
plain version `ref.paged_prefill_ref` over the same walk. On the card
the walk is split into ranges (`walk_ranges`) whose softmax states the
kernel merges through scratch that the wrapper allocates.

Layouts (the reference's):
    q            [B, T, H, hd]           suffix queries (RoPE applied)
    k/v_pages    [n_blocks, bs, KV, hd]  suffix KV already scattered in
    block_table  [B, max_blocks] int32
    start/total  [B] int32
    out          [B, T, H, hd] f32
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

#: kernel launches made by this process; only the CUDA launch below
#: increments it
LAUNCHES = 0

_ARGTYPES = (
    [ctypes.c_void_p] * 12           # q, k/v pools, k/v scales, table,
                                     # start, total, block_start, out,
                                     # part_acc, part_ml
    + [ctypes.c_int] * 13            # q/kv dtype, B, T, H, KV, hd, bs,
                                     # mb, depth, window, n_ranges,
                                     # range_chunks
    + [ctypes.c_float, ctypes.c_void_p]   # scale, stream
)

#: keys a fold step takes (csrc/paged_prefill.cu kChunkKeys)
CHUNK_KEYS = 16
#: walk chunks per range, and the most ranges a launch splits into
RANGE_CHUNKS = 32
MAX_RANGES = 4


def walk_ranges(mb: int, bs: int):
    """`(count, chunks)`: the kernel splits the page walk into `count`
    ranges of `chunks` chunks (16 keys each), one CTA per query tile and
    range, and merges the ranges' softmax states in order. It halves
    the longest chain of dependent fold steps at the main path's 1088
    tokens of capacity. A function of the table's width and the page
    size only, so every launch of a serving run splits at the same table
    positions and a row's output never depends on how the rows are
    batched, chunked or bucketed."""
    n_chunks = mb * -(-bs // CHUNK_KEYS)
    count = min(-(-n_chunks // RANGE_CHUNKS), MAX_RANGES)
    return count, -(-n_chunks // count)


def paged_prefill_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    start: torch.Tensor,
    total: torch.Tensor,
    window: int,
    *,
    k_scales=None,
    v_scales=None,
    block_start=None,
    depth=None,
) -> torch.Tensor:
    """One K2 launch; f32 [B, T, H, hd]. `depth`/`block_start` bound the
    walk as in `paged_decode_attention`; int8 pools bring their scales."""
    global LAUNCHES
    check_quantized_operands(k_pages, k_scales, v_scales)
    b, t, h, hd = q.shape
    mb = block_table.shape[1]
    depth = mb if depth is None else int(depth)
    if not 1 <= depth <= mb:
        raise ValueError(f"depth {depth} outside [1, {mb}]")
    if q.device.type == "cpu":
        return ref.paged_prefill_ref(
            q, k_pages, v_pages, block_table, start, total, window,
            k_scales=k_scales, v_scales=v_scales,
            block_start=block_start, depth=depth,
        )
    check_kernel_operands(
        "paged_prefill", q, k_pages, v_pages, k_scales, v_scales,
        block_table,
        {"start": start, "total": total, "block_start": block_start},
    )
    out = torch.empty((b, t, h, hd), dtype=torch.float32, device=q.device)
    if b == 0 or t == 0:
        return out
    _, bs, n_kv, _ = k_pages.shape
    n_ranges, range_chunks = walk_ranges(mb, bs)
    part_acc = part_ml = None
    if n_ranges > 1:
        part_acc = torch.empty((n_ranges, b, t, h, hd), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((n_ranges, b, t, h, 2), dtype=torch.float32,
                              device=q.device)
    launch_kernel("paged_prefill", "paged_prefill_launch", _ARGTYPES, (
        ptr(q), ptr(k_pages), ptr(v_pages), ptr(k_scales), ptr(v_scales),
        ptr(block_table), ptr(start), ptr(total), ptr(block_start),
        ptr(out), ptr(part_acc), ptr(part_ml), DTYPE_CODES[q.dtype],
        DTYPE_CODES[k_pages.dtype], b, t, h, n_kv, hd, bs, mb, depth,
        int(window), n_ranges, range_chunks, float(hd ** -0.5),
    ), q.device)
    LAUNCHES += 1
    return out


def paged_prefill_attention_bucketed(
    q, k_pages, v_pages, block_table, start, total, window, plan, perm, *,
    k_scales=None, v_scales=None, block_start=None,
) -> torch.Tensor:
    """One `paged_prefill_attention` launch per occupancy bucket.
    Bit-identical to the single launch on every valid query row
    (start + t < total)."""
    if block_start is None:
        block_start = torch.zeros_like(start)

    def launch(bound, bt_rows, q_rows, start_rows, total_rows, blk_rows):
        return paged_prefill_attention(
            q_rows, k_pages, v_pages, bt_rows, start_rows, total_rows,
            window, k_scales=k_scales, v_scales=v_scales,
            block_start=blk_rows, depth=bound,
        )

    return bucketed_page_dispatch(
        launch, plan, perm, block_table, [q, start, total, block_start],
    )


def paged_prefill(
    q, k_pages, v_pages, block_table, start, total, window, *,
    impl: str = "auto", k_scales=None, v_scales=None, plan=None,
    perm=None, block_start=None,
) -> torch.Tensor:
    """Impl dispatch (`ops.resolve_impl`), as `paged_attention`; either
    route reports the same work (`work.prefill_work`)."""
    check_quantized_operands(k_pages, k_scales, v_scales)
    with work.dispatch("paged_prefill", lambda: work.prefill_work(
            q, k_pages, block_table, start, total, window, k_scales,
            block_start)):
        if resolve_impl(impl, q.device) == "ref":
            return ref.paged_prefill_ref(
                q, k_pages, v_pages, block_table, start, total, window,
                k_scales=k_scales, v_scales=v_scales,
            )
        if plan is not None:
            return paged_prefill_attention_bucketed(
                q, k_pages, v_pages, block_table, start, total, window,
                plan, perm, k_scales=k_scales, v_scales=v_scales,
                block_start=block_start,
            )
        return paged_prefill_attention(
            q, k_pages, v_pages, block_table, start, total, window,
            k_scales=k_scales, v_scales=v_scales, block_start=block_start,
        )
