"""GQA attention, dense and paged: counterpart of
`repro.models.attention` (its lines 29-291 and 294-509).

Dense path (`attention_forward`, `attention_prefill`,
`attention_decode`): full-sequence attention over the fresh K/V, dense
below `DENSE_SCORE_LIMIT` score elements per (batch, head) and an
online-softmax walk over q and kv blocks above it, as in the reference
— the two sum in different orders, so the switch is kept exactly. The
reference computes these in jnp outside any Pallas kernel; here they are
plain torch ops with the same f32 arithmetic, not
`scaled_dot_product_attention`. The per-layer caches passed in are
views of the stacked `[L, B, S, KV, hd]` cache and are written IN PLACE.

Paged path: the reference's pools are immutable and each call returns
new ones. Here the per-layer pools passed in are views of the stacked
`[L, n_blocks, ...]` pools, and the KV append writes into them in place
(`index_put_`); the functions still return the pools so the call shape
matches the reference's.

Every projection goes through `quant.pim_linear` with the step's
`impl`, so PIM bit-plane weights run on K3/K4 (or their plain versions
under `impl="ref"`). The dense path carries the reference's heads hooks:
under tensor parallelism (`dist.parallel`) each rank projects its
column blocks, attends with its query heads and the K/V heads they read,
and sums `wo`'s row-parallel partial products over ``model``.
"""

from __future__ import annotations

import contextvars
from typing import Optional, Tuple

import torch

from ..dist.parallel import (
    enter,
    kv_for_heads,
    local_columns,
    row_linear,
    shard_heads,
)
from ..kernels.paged_attention import paged_attention
from ..kernels.paged_common import requantize_page_update
from ..kernels.paged_prefill import paged_prefill
from ..quant.bitplane import pim_linear
from .common import NEG_INF, Params, apply_rope, dense_init
from .scan import scan


#: while a piecewise decode graph is captured (`serve.graphs`), the cut
#: each `attention_decode_paged` call hands its K1 call to, with the
#: arguments of `_select_bucket_plan`; None (any other time) runs K1 here
K1_CUT = contextvars.ContextVar("k1_cut", default=None)


def _select_bucket_plan(call, bucket_plans, bucket_perms, plan_class):
    """Run `call(plan, perm)` under the layer's bucket-plan variant. The
    reference selects with `lax.switch` on a traced group id; here the
    group id is a host int and the select is plain indexing."""
    if bucket_plans is None:
        return call(None, None)
    idx = 0 if plan_class is None or len(bucket_plans) == 1 else plan_class
    return call(bucket_plans[idx], bucket_perms[idx])


def init_attention(d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, qkv_bias: bool, generator, device,
                   dtype=torch.float32, out=None) -> Params:
    """`out`: preallocated leaves to fill instead of new tensors."""
    def o(name):
        return None if out is None else out[name]
    p: Params = {
        "wq": dense_init(d_model, n_heads * head_dim, generator, device,
                         dtype, o("wq")),
        "wk": dense_init(d_model, n_kv_heads * head_dim, generator, device,
                         dtype, o("wk")),
        "wv": dense_init(d_model, n_kv_heads * head_dim, generator, device,
                         dtype, o("wv")),
        "wo": dense_init(n_heads * head_dim, d_model, generator, device,
                         dtype, o("wo")),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv_heads),
                            ("bv", n_kv_heads)):
            p[name] = (torch.zeros((width * head_dim,), dtype=dtype,
                                   device=device)
                       if out is None else out[name].zero_())
    return p


def _project_qkv(params, x, n_heads, n_kv, hd, impl):
    """q [B, T, H, hd], k and v [B, T, KV, hd] — under tensor parallelism
    the heads each rank holds, as the heads hooks place them."""
    x = enter(x)
    q = pim_linear(x, params["wq"], impl)
    k = pim_linear(x, params["wk"], impl)
    v = pim_linear(x, params["wv"], impl)
    if "bq" in params:
        q = q + local_columns(params["bq"], q.shape[-1]).to(q.dtype)
        k = k + local_columns(params["bk"], k.shape[-1]).to(k.dtype)
        v = v + local_columns(params["bv"], v.shape[-1]).to(v.dtype)
    return (shard_heads(q, n_heads, hd, "heads"),
            shard_heads(k, n_kv, hd, "kv_heads"),
            shard_heads(v, n_kv, hd, "kv_heads"))


def _gqa_core(
    q: torch.Tensor,            # [B, T, H, hd]
    k: torch.Tensor,            # [B, S, KV, hd]
    v: torch.Tensor,            # [B, S, KV, hd]
    mask: Optional[torch.Tensor],  # [B or 1, T, S] additive f32, or None
) -> torch.Tensor:
    b, t, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, t, kv, g, hd)
    scale = hd ** -0.5
    scores = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float()) * scale
    if mask is not None:
        scores = scores + mask[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v.float())
    return out.reshape(b, t, h * hd).to(q.dtype)


#: q / kv block of the online-softmax walk
Q_BLOCK = 512
KV_BLOCK = 1024
#: above this many score elements per (batch, head) the dense form would
#: hold a [T, S] buffer; the walk over blocks takes over
DENSE_SCORE_LIMIT = 1 << 21


def _pick_block(n: int, target: int) -> int:
    bl = min(target, n)
    while n % bl:
        bl //= 2
    return max(bl, 1)


def _chunked_gqa(
    q: torch.Tensor,            # [B, T, H, hd]
    k: torch.Tensor,            # [B, S, KV, hd]
    v: torch.Tensor,
    q_pos: torch.Tensor,        # [T]
    kv_pos: torch.Tensor,       # [S]
    window: Optional[int],
    causal: bool,
) -> torch.Tensor:
    """Online-softmax attention, in the reference's arithmetic: kv blocks
    of `_pick_block(S, KV_BLOCK)` walked in order, running max and sum in
    f32, the `max(l, 1e-30)` epilogue. The kv block edges are where the
    running sums merge, so they follow the reference exactly. A q row's
    arithmetic does not depend on which rows share its block, so q rows
    are taken Q_BLOCK at a time (the last group ragged) where the
    reference takes `_pick_block(T, Q_BLOCK)` — which falls to 1 row for
    an odd T and would make this Python loop T times longer. Each
    block's scores are dropped before the next, so one
    [B, KV, G, Q_BLOCK, kb] f32 block (and its exponentials) is alive
    at a time. Both walks are `models.scan`s."""
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    kb = _pick_block(s, KV_BLOCK)
    scale = hd ** -0.5

    def q_block(_, i):
        qp = q_pos[i * Q_BLOCK: (i + 1) * Q_BLOCK]
        qb = qp.shape[0]
        qf = q[:, i * Q_BLOCK: i * Q_BLOCK + qb].reshape(
            b, qb, kvh, g, hd).float() * scale

        def kv_block(run, j):
            acc, m, l = run
            kp = kv_pos[j * kb: (j + 1) * kb]
            scores = torch.einsum("bqkgh,bskh->bkgqs", qf,
                                  k[:, j * kb: (j + 1) * kb].float())
            ok = torch.ones((qb, kb), dtype=torch.bool, device=q.device)
            if causal:
                ok = ok & (kp[None, :] <= qp[:, None])
            if window is not None:
                ok = ok & (kp[None, :] > qp[:, None] - window)
            scores = torch.where(ok, scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            del scores
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1)
            acc = alpha[..., None] * acc + torch.einsum(
                "bkgqs,bskh->bkgqh", p, v[:, j * kb: (j + 1) * kb].float())
            return (acc, m_new, l), ()

        (acc, _, l), _ = scan(kv_block, (
            torch.zeros((b, kvh, g, qb, hd), dtype=torch.float32,
                        device=q.device),
            torch.full((b, kvh, g, qb), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, kvh, g, qb), dtype=torch.float32,
                        device=q.device)), s // kb)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return None, (out.permute(0, 3, 1, 2, 4).reshape(b, qb, h * hd),)

    _, (out,) = scan(q_block, None, -(-t // Q_BLOCK), join=(("cat", 1),),
                     alike=t // Q_BLOCK)
    return out.to(q.dtype)


def _full_seq_attention(q, k, v, q_pos, kv_pos, window, causal):
    """Dense or chunked by score-buffer size, as the reference picks."""
    t, s = q.shape[1], k.shape[1]
    if t * s <= DENSE_SCORE_LIMIT:
        if causal:
            ok = kv_pos[None, :] <= q_pos[:, None]
            if window is not None:
                ok = ok & (kv_pos[None, :] > q_pos[:, None] - window)
            mask = torch.where(ok, 0.0, NEG_INF).float()[None]
        else:
            mask = None
        return _gqa_core(q, k, v, mask)
    return _chunked_gqa(q, k, v, q_pos, kv_pos, window, causal)


def attention_forward(
    params: Params,
    x: torch.Tensor,            # [B, T, D]
    positions: torch.Tensor,    # [T] int
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: Optional[int] = None,  # None = full causal
    causal: bool = True,           # False = bidirectional (encoder)
    impl: str = "auto",
) -> torch.Tensor:
    """Full-sequence attention (training / prefill logits)."""
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim, impl)
    q = apply_rope(q, positions[None, :], rope_theta)
    k = apply_rope(k, positions[None, :], rope_theta)
    out = _full_seq_attention(
        q, *kv_for_heads(q.shape[2], n_heads, n_kv_heads, k, v), positions,
        positions, window, causal)
    return row_linear(out, params["wo"], n_heads * head_dim, impl)


def attention_prefill(
    params: Params,
    x: torch.Tensor,            # [B, T, D]
    positions: torch.Tensor,    # [T] int
    cache_k: torch.Tensor,      # [B, S, KV, hd] — this layer's cache
    cache_v: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: Optional[int] = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill: causal attention over the prompt; its KV is written into
    rows [0, T) of the cache in place."""
    t = x.shape[1]
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim, impl)
    q = apply_rope(q, positions[None, :], rope_theta)
    k = apply_rope(k, positions[None, :], rope_theta)
    cache_k[:, :t] = k.to(cache_k.dtype)
    cache_v[:, :t] = v.to(cache_v.dtype)
    out = _full_seq_attention(
        q, *kv_for_heads(q.shape[2], n_heads, n_kv_heads, k, v), positions,
        positions, window, causal=True)
    return row_linear(out, params["wo"], n_heads * head_dim, impl), \
        cache_k, cache_v


def decode_position(position: int, device) -> torch.Tensor:
    """The RoPE position `[1, 1]` of a decode step's new token."""
    return torch.full((1, 1), position, dtype=torch.int64, device=device)


def decode_mask(position: int, s: int, window: Optional[int],
                device) -> torch.Tensor:
    """Additive decode mask `[1, 1, S]` over the cache rows: 0 where
    `kv_pos <= position` (and `> position - window`), else NEG_INF."""
    kv_pos = torch.arange(s, device=device)
    ok = kv_pos <= position
    if window is not None:
        ok = ok & (kv_pos > position - window)
    return torch.where(ok, 0.0, NEG_INF).float()[None, None, :]


def attention_decode(
    params: Params,
    x: torch.Tensor,            # [B, 1, D]
    position: int,              # index of the new token, shared by all rows
    cache_k: torch.Tensor,      # [B, S, KV, hd] — this layer's cache
    cache_v: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: Optional[int] = None,
    impl: str = "auto",
    rope_pos: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against the cache, the paper's workload: a batch
    of GEMVs against PIM-resident weights and a KV-cache sweep.

    The new KV row is written in place at `min(max(position, 0), S - 1)`:
    the reference writes with `dynamic_update_slice`, which clamps its
    start index so, while RoPE and the mask (`kv_pos <= position`, and
    `> position - window`) take the unclamped position. `position` is a
    host int, so building the mask and the write index reads nothing
    back from the device. A caller that runs many layers at one position
    passes `rope_pos = decode_position(position, device)` and `mask =
    decode_mask(position, S, window, device)`, built once per step (and
    window), instead of once per layer."""
    s = cache_k.shape[1]
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim, impl)
    if rope_pos is None:
        rope_pos = decode_position(position, x.device)
    q = apply_rope(q, rope_pos, rope_theta)
    k = apply_rope(k, rope_pos, rope_theta)
    row = min(max(position, 0), s - 1)
    cache_k[:, row] = k[:, 0].to(cache_k.dtype)
    cache_v[:, row] = v[:, 0].to(cache_v.dtype)
    if mask is None:
        mask = decode_mask(position, s, window, x.device)
    out = _gqa_core(q, *kv_for_heads(q.shape[2], n_heads, n_kv_heads,
                                     cache_k, cache_v), mask)
    return row_linear(out, params["wo"], n_heads * head_dim, impl), \
        cache_k, cache_v


def attention_decode_paged(
    params: Params,
    x: torch.Tensor,            # [B, 1, D] — one new token per slot
    positions: torch.Tensor,    # [B] int32 — per-slot index of the new token
    k_pages: torch.Tensor,      # [n_blocks, bs, KV, hd] this layer's pool
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_blocks] int32
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: Optional[int] = None,  # None = full causal
    impl: str = "auto",
    block_start: Optional[torch.Tensor] = None,  # [B] first live block
    bucket_plans=None,
    bucket_perms=None,
    plan_class=None,
    k_scales: Optional[torch.Tensor] = None,  # [n_blocks, KV] f32 (int8)
    v_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """One-token decode against a block-paged cache: each slot's new KV
    row goes to page `block_table[b, pos // bs]`, offset `pos % bs`
    (idle slots all target scratch page 0, the only page that may
    receive duplicate writes), then K1 runs over each slot's ragged
    length.

    int8 pools: the one touched page per slot is dequantized, the new
    row scattered in, and the page requantized under its new absmax;
    codes and scales are written back in place and the return grows to
    `(out, k_pages, v_pages, k_scales, v_scales)`.

    While a piecewise decode graph is captured (`serve.graphs`), the K1
    call goes to the capture's cut (`K1_CUT`) instead."""
    b = x.shape[0]
    bs = k_pages.shape[1]
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim,
                           impl)
    q = apply_rope(q, positions[:, None], rope_theta)
    k = apply_rope(k, positions[:, None], rope_theta)
    pos = positions.long()
    rows = torch.arange(b, device=x.device)
    page = block_table[rows, pos // bs].long()                 # [B]
    offset = pos % bs
    if k_scales is None:
        k_pages[page, offset] = k[:, 0].to(k_pages.dtype)
        v_pages[page, offset] = v[:, 0].to(v_pages.dtype)
    else:
        def scatter_row(new):                      # new: [B, KV, hd]
            def upd(pages_f):                      # [B, bs, KV, hd] f32
                pages_f[rows, offset] = new.float()
                return pages_f
            return upd

        k_codes, k_sc = requantize_page_update(
            k_pages[page], k_scales[page], scatter_row(k[:, 0])
        )
        v_codes, v_sc = requantize_page_update(
            v_pages[page], v_scales[page], scatter_row(v[:, 0])
        )
        k_pages[page] = k_codes
        v_pages[page] = v_codes
        k_scales[page] = k_sc
        v_scales[page] = v_sc
    capacity = block_table.shape[1] * bs
    win = capacity if window is None else int(window)
    lengths = (positions + 1).to(torch.int32)
    q1 = q[:, 0].contiguous()

    def call(plan, perm):
        return paged_attention(
            q1, k_pages, v_pages, block_table, lengths, win,
            impl=impl, plan=plan, perm=perm, block_start=block_start,
            k_scales=k_scales, v_scales=v_scales,
        )                                                    # [B, H, hd] f32

    cut = K1_CUT.get()
    if cut is None:
        out = _select_bucket_plan(call, bucket_plans, bucket_perms,
                                  plan_class)
    else:
        out = cut(call, bucket_plans, bucket_perms, plan_class)
    out = out.reshape(b, 1, n_heads * head_dim).to(x.dtype)
    out = pim_linear(out, params["wo"], impl)
    if k_scales is None:
        return out, k_pages, v_pages
    return out, k_pages, v_pages, k_scales, v_scales


def attention_prefill_paged(
    params: Params,
    x: torch.Tensor,            # [B, T, D] — uncached suffix tokens (T padded)
    start: torch.Tensor,        # [B] int32 — cached-prefix length per slot
    total: torch.Tensor,        # [B] int32 — full valid length per slot
    k_pages: torch.Tensor,      # [n_blocks, bs, KV, hd] this layer's pool
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_blocks] int32
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: Optional[int] = None,
    impl: str = "auto",
    block_start: Optional[torch.Tensor] = None,
    bucket_plans=None,
    bucket_perms=None,
    plan_class=None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Suffix prefill against a block-paged cache: suffix token t sits at
    `start + t` (RoPE there), its KV goes to page
    `block_table[b, (start+t) // bs]`, and K2 runs over the cached prefix
    and the fresh suffix. Pad rows whose position falls past the table
    go to scratch page 0 — never clamped onto the slot's last page.
    Chunked prefill is this call repeated with an advancing `start`.

    int8 pools: the slot's table row is dequantized, the suffix scattered
    in (pad rows to a dummy row, so a ragged last page is scaled by valid
    tokens only), and requantized; touched columns write back in place,
    untouched ones — shared prefix pages included — write to scratch page
    0, so a shared page is never written."""
    b, t, _ = x.shape
    bs = k_pages.shape[1]
    mb = block_table.shape[1]
    dev = x.device
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim,
                           impl)
    positions = start.long()[:, None] + torch.arange(t, device=dev)[None, :]
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    block_idx = positions // bs                              # [B, T]
    offset = positions % bs
    if k_scales is None:
        page = torch.gather(block_table.long(), 1,
                            block_idx.clamp(max=mb - 1))
        page = torch.where(block_idx < mb, page, 0)
        k_pages[page, offset] = k.to(k_pages.dtype)
        v_pages[page, offset] = v.to(v_pages.dtype)
    else:
        valid = (positions < total.long()[:, None]) & (block_idx < mb)
        row = torch.where(valid, block_idx, mb)              # pads → dummy
        col = torch.arange(mb, device=dev)[None, :]
        touched = (col >= (start.long() // bs)[:, None]) & (
            col * bs < total.long()[:, None]
        )
        bt = block_table.long()
        write_pages = torch.where(touched, bt, 0)
        rows = torch.arange(b, device=dev)[:, None]

        def scatter_suffix(new):                   # new: [B, T, KV, hd]
            def upd(pages_f):                      # [B, mb, bs, KV, hd] f32
                padded = torch.cat(
                    [pages_f, torch.zeros_like(pages_f[:, :1])], dim=1
                )
                padded[rows, row, offset] = new.float()
                return padded[:, :mb]
            return upd

        k_codes, k_sc = requantize_page_update(
            k_pages[bt], k_scales[bt], scatter_suffix(k)
        )
        v_codes, v_sc = requantize_page_update(
            v_pages[bt], v_scales[bt], scatter_suffix(v)
        )
        k_pages[write_pages] = k_codes
        v_pages[write_pages] = v_codes
        k_scales[write_pages] = k_sc
        v_scales[write_pages] = v_sc
    capacity = mb * bs
    win = capacity if window is None else int(window)
    qc = q.contiguous()

    def call(plan, perm):
        return paged_prefill(
            qc, k_pages, v_pages, block_table, start, total, win,
            impl=impl, plan=plan, perm=perm, block_start=block_start,
            k_scales=k_scales, v_scales=v_scales,
        )                                                    # [B, T, H, hd]

    out = _select_bucket_plan(call, bucket_plans, bucket_perms, plan_class)
    out = out.reshape(b, t, n_heads * head_dim).to(x.dtype)
    out = pim_linear(out, params["wo"], impl)
    if k_scales is None:
        return out, k_pages, v_pages
    return out, k_pages, v_pages, k_scales, v_scales


# ---------------------------------------------------------------------------
# cross-attention (the encoder-decoder's decoder)
# ---------------------------------------------------------------------------

def init_cross_attention(d_model: int, n_heads: int, head_dim: int,
                         generator, device, dtype=torch.float32,
                         out=None) -> Params:
    """`out`: preallocated leaves to fill instead of new tensors."""
    def o(name):
        return None if out is None else out[name]
    width = n_heads * head_dim
    return {
        "wq": dense_init(d_model, width, generator, device, dtype, o("wq")),
        "wk": dense_init(d_model, width, generator, device, dtype, o("wk")),
        "wv": dense_init(d_model, width, generator, device, dtype, o("wv")),
        "wo": dense_init(width, d_model, generator, device, dtype, o("wo")),
    }


def cross_attention_kv(params: Params, enc_out: torch.Tensor, n_heads: int,
                       hd: int, impl: str = "auto"):
    """The encoder's K and V [B, S, H, hd], once per layer."""
    enc_out = enter(enc_out)
    k = shard_heads(pim_linear(enc_out, params["wk"], impl), n_heads, hd,
                    "heads")
    v = shard_heads(pim_linear(enc_out, params["wv"], impl), n_heads, hd,
                    "heads")
    return k, v


def cross_attention_forward(
    params: Params,
    x: torch.Tensor,            # [B, T, D] decoder states
    k: torch.Tensor,            # [B, S, H, hd] precomputed encoder K
    v: torch.Tensor,
    n_heads: int,
    head_dim: int,
    impl: str = "auto",
) -> torch.Tensor:
    """Every decoder position attends to every encoder position: the
    non-causal full-sequence attention, no RoPE."""
    t, s = x.shape[1], k.shape[1]
    q = shard_heads(pim_linear(enter(x), params["wq"], impl), n_heads,
                    head_dim, "heads")
    out = _full_seq_attention(q, k, v, torch.arange(t, device=x.device),
                              torch.arange(s, device=x.device), None,
                              causal=False)
    return row_linear(out, params["wo"], n_heads * head_dim, impl)
