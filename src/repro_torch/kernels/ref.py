"""Plain PyTorch versions of the paged-attention kernels K1 and K2:
counterpart of `repro.kernels.ref` (its lines 140-252).

Dense-gather every slot's pages and run the masked GQA softmax. With
the default arguments the math is the reference oracle's, line for
line, including the don't-care rows (length-0 slots, padded suffix
rows): the finite `NEG_INF` sentinel and the `acc / max(l, 1e-30)`
epilogue keep them finite instead of NaN.

`block_start` / `depth` are the port's addition: they restrict the
gather to the table columns a depth-bounded kernel walk visits —
`[s, s + depth)` with `s = max(min(block_start, mb - depth), 0)` — so
the plain version also stands in for one bucketed launch. Positions
come from the table column, never from the walk step. Columns outside
the walk hold only masked positions for the slots a plan puts there,
so restricting the gather changes a valid row only by f32 rounding (the
shorter sums add the same exact zeros in another order).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _walk_columns(block_table: torch.Tensor, block_start, depth):
    """[B, depth] table columns of the (possibly bounded) walk."""
    b, mb = block_table.shape
    depth = mb if depth is None else depth
    cols = torch.arange(depth, device=block_table.device)[None, :].expand(
        b, depth
    )
    if block_start is not None:
        s = torch.clamp(block_start.long().clamp(max=mb - depth), min=0)
        cols = cols + s[:, None]
    return cols


def _gather_kv_dense(pages, page_ids, scales=None):
    """Dense-gather pages per slot ([B, n] page ids), dequantizing int8
    codes when the per-page scales ride along."""
    b, n = page_ids.shape
    _, bs, kv, hd = pages.shape
    gathered = pages[page_ids]                          # [B, n, bs, KV, hd]
    if scales is not None:
        from .paged_common import dequantize_pages
        gathered = dequantize_pages(gathered, scales[page_ids])
    return gathered.reshape(b, n * bs, kv, hd)


def _gather_walk(k_pages, v_pages, block_table, k_scales, v_scales,
                 block_start, depth):
    bs = k_pages.shape[1]
    cols = _walk_columns(block_table, block_start, depth)
    page_ids = torch.gather(block_table.long(), 1, cols)
    k = _gather_kv_dense(k_pages, page_ids, k_scales)    # [B, S, KV, hd]
    v = _gather_kv_dense(v_pages, page_ids, v_scales)
    kv_pos = (
        cols[:, :, None] * bs
        + torch.arange(bs, device=cols.device)[None, None, :]
    ).reshape(cols.shape[0], -1)                          # [B, S]
    return k, v, kv_pos


def paged_attention_ref(
    q: torch.Tensor,            # [B, H, hd] — one query token per slot
    k_pages: torch.Tensor,      # [n_blocks, block_size, KV, hd]
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_blocks] int32 page ids per slot
    lengths: torch.Tensor,      # [B] int32 valid KV count per slot
    window,                     # int; kv_pos > q_pos - window
    k_scales: Optional[torch.Tensor] = None,  # [n_blocks, KV] f32
    v_scales: Optional[torch.Tensor] = None,  # (int8 pools only)
    block_start: Optional[torch.Tensor] = None,  # [B] first live block
    depth: Optional[int] = None,                 # walk depth (None = mb)
) -> torch.Tensor:
    """Plain K1: f32 [B, H, hd]. The query sits at `lengths - 1`;
    positions are masked unless `kv_pos < length` and
    `kv_pos > length - 1 - window`."""
    b, h, hd = q.shape
    kv = k_pages.shape[2]
    g = h // kv
    k, v, kv_pos = _gather_walk(k_pages, v_pages, block_table, k_scales,
                                v_scales, block_start, depth)
    lengths = lengths.long()
    q_pos = (lengths - 1)[:, None]
    ok = (kv_pos < lengths[:, None]) & (kv_pos > q_pos - window)
    scores = torch.einsum(
        "bkgh,bskh->bkgs", q.reshape(b, kv, g, hd).float(), k.float()
    ) * (hd ** -0.5)
    scores = torch.where(ok[:, None, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, hd)


def paged_prefill_ref(
    q: torch.Tensor,            # [B, T, H, hd] — suffix queries (T padded)
    k_pages: torch.Tensor,      # [n_blocks, block_size, KV, hd]
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_blocks] int32 page ids per slot
    start: torch.Tensor,        # [B] int32 — position of the first suffix token
    total: torch.Tensor,        # [B] int32 — full valid length
    window,                     # int; kv_pos > q_pos - window
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    block_start: Optional[torch.Tensor] = None,
    depth: Optional[int] = None,
) -> torch.Tensor:
    """Plain K2: f32 [B, T, H, hd]. Suffix row t sits at `start + t` and
    sees `kv_pos <= start + t`, `kv_pos < total` and
    `kv_pos > start + t - window`. The suffix KV must already be in the
    pools; rows with `start + t >= total` are don't-care."""
    b, t, h, hd = q.shape
    kv = k_pages.shape[2]
    g = h // kv
    k, v, kv_pos = _gather_walk(k_pages, v_pages, block_table, k_scales,
                                v_scales, block_start, depth)
    kv_pos = kv_pos[:, None, :]                              # [B, 1, S]
    q_pos = (
        start.long()[:, None] + torch.arange(t, device=q.device)[None, :]
    )[..., None]                                             # [B, T, 1]
    ok = (
        (kv_pos <= q_pos)
        & (kv_pos < total.long()[:, None, None])
        & (kv_pos > q_pos - window)
    )                                                        # [B, T, S]
    scores = torch.einsum(
        "btkgh,bskh->bkgts", q.reshape(b, t, kv, g, hd).float(), k.float()
    ) * (hd ** -0.5)
    scores = torch.where(ok[:, None, None], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgts,bskh->bkgth", p, v.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd)
