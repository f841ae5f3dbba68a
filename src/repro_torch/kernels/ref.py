"""Plain PyTorch versions of the port's kernels: counterpart of
`repro.kernels.ref`.

Bit-plane half (K3 GEMV, K4 GEMM, K5 pack; the reference's lines
29-134). An n-bit signed weight matrix is stored as `n_digits` planes of
g-bit digits, 8/g digits packed per byte along the contraction (K)
dimension:

    W_q [K, M]  (int, two's complement, n_bits)
    U = W_q + 2^(n-1)                      unsigned offset form
    digit_j(U) = (U >> (g*j)) & (2^g - 1)  j = 0..n_digits-1
    planes[j, kq, m] byte = sum_r digit_j(U[kq*(8/g)+r, m]) << (g*r)

so `planes` is [n_digits, K*g//8, M] uint8 and

    x @ W_q = x @ U - 2^(n-1) * sum_k x_k

K3 and K4 compute the raw contraction `x @ U` in f32
(`bitplane_raw_ref` is its plain version); `ops.bitplane_matmul` applies
the offset and the per-channel scale. Dtype rules follow the reference
exactly, so planes and scales are bit-equal to its own: a bf16 weight
gives a bf16 `absmax / qmax` before the f32 cast, `w / scale` promotes
to f32, and `round` is half-to-even in both frameworks.

Paged-attention half (K1, K2; the reference's lines 140-252).
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

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# bit-plane weights (K3, K4, K5)
# ---------------------------------------------------------------------------

def check_dims(k: int, n_bits: int, group: int) -> int:
    """Validate a bit-plane format; returns digits per byte (8/g)."""
    if group not in (1, 2, 4):
        raise ValueError(f"group must be 1, 2 or 4, got {group}")
    if not 2 <= n_bits <= 8:
        raise ValueError(f"n_bits must be in [2, 8], got {n_bits}")
    digits_per_byte = 8 // group
    if k % digits_per_byte:
        raise ValueError(f"K={k} not a multiple of {digits_per_byte}")
    return digits_per_byte


def n_digits(n_bits: int, group: int) -> int:
    return -(-n_bits // group)


def quantize_ref(w: torch.Tensor, n_bits: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel quantization of W [K, M].

    Returns (w_q int32 [K, M], scale f32 [M]) with w_q in
    [-2^(n-1), 2^(n-1)-1]."""
    qmax = float(2 ** (n_bits - 1) - 1)
    absmax = w.abs().amax(dim=0)
    scale = torch.where(absmax > 0, absmax / qmax, 1.0).float()
    w_q = torch.clamp(torch.round(w / scale), -(qmax + 1), qmax)
    return w_q.to(torch.int32), scale


def pack_ref(w_q: torch.Tensor, n_bits: int, group: int = 1
             ) -> torch.Tensor:
    """Pack signed w_q [K, M] into digit planes [n_digits, K*g//8, M] u8."""
    k, m = w_q.shape
    dpb = check_dims(k, n_bits, group)
    u = (w_q.to(torch.int32) + 2 ** (n_bits - 1)).reshape(k // dpb, dpb, m)
    digit_mask = (1 << group) - 1
    shifts = (group * torch.arange(dpb, dtype=torch.int32,
                                   device=w_q.device))[None, :, None]
    planes = []
    for j in range(n_digits(n_bits, group)):
        digits = (u >> (group * j)) & digit_mask            # [K8, dpb, M]
        planes.append((digits << shifts).sum(dim=1).to(torch.uint8))
    return torch.stack(planes, dim=0)


def pack_bitplanes_ref(u_r: torch.Tensor, n_bits: int, group: int = 1
                       ) -> torch.Tensor:
    """Plain K5: pre-strided offset weights u_r [8/g, K8, M] uint8
    (u_r[r, q, m] = U[q*8/g + r, m]) -> planes [n_digits, K8, M] uint8."""
    dpb, k8, m = u_r.shape
    u = u_r.permute(1, 0, 2).reshape(k8 * dpb, m).to(torch.int32)
    return pack_ref(u - 2 ** (n_bits - 1), n_bits, group)


def offset_form_ref(planes: torch.Tensor, group: int = 1) -> torch.Tensor:
    """The unsigned offset form U [K, M] uint8 that `planes` store."""
    nd, k8, m = planes.shape
    dpb = 8 // group
    digit_mask = (1 << group) - 1
    shifts = (group * torch.arange(dpb, dtype=torch.uint8,
                                   device=planes.device))[None, :, None]
    u = torch.zeros((k8, dpb, m), dtype=torch.uint8, device=planes.device)
    for j in range(nd):
        digits = (planes[j][:, None, :] >> shifts) & digit_mask
        u |= digits << (group * j)
    return u.reshape(k8 * dpb, m)


def unpack_ref(planes: torch.Tensor, n_bits: int, group: int = 1
               ) -> torch.Tensor:
    """Inverse of pack_ref: planes -> signed w_q [K, M] int32."""
    return offset_form_ref(planes, group).to(torch.int32) - 2 ** (n_bits - 1)


def prepare_x_ref(x: torch.Tensor, group: int = 1) -> torch.Tensor:
    """x [B, K] -> x_r [8/g, B, K*g//8] with x_r[r, :, q] = x[:, q*(8/g)+r]
    (a view; the kernels take it contiguous)."""
    b, k = x.shape
    dpb = 8 // group
    return x.reshape(b, k // dpb, dpb).permute(2, 0, 1)


def bitplane_raw_ref(x_r: torch.Tensor, planes: torch.Tensor,
                     group: int = 1) -> torch.Tensor:
    """Plain K3/K4: the raw contraction f32 [B, M] = x @ U, with x taken
    back from its pre-strided form x_r [8/g, B, K8]."""
    dpb, b, k8 = x_r.shape
    x = x_r.permute(1, 2, 0).reshape(b, k8 * dpb)
    return x.float() @ offset_form_ref(planes, group).float()


def every_expert_ref(expert: torch.Tensor, n_experts: int,
                     matmul) -> torch.Tensor:
    """Plain grouped product: `matmul(e)` [P, M] over every row for each
    expert e, each row keeping its own expert's `expert[p]`. No matmul
    shape follows the routing and nothing is read on the host, so a
    row's arithmetic depends on no other row; it is E times the work,
    for the CPU and for checks."""
    every = torch.stack([matmul(e) for e in range(n_experts)])
    return every[expert, torch.arange(expert.shape[0],
                                      device=expert.device)]


def bitplane_matmul_ref(
    x: torch.Tensor,
    planes: torch.Tensor,
    scale: torch.Tensor,
    n_bits: int,
    group: int = 1,
) -> torch.Tensor:
    """Oracle: y = x @ dequant(planes) — computed the straightforward way
    (unpack to int, matmul in f32)."""
    w_q = unpack_ref(planes, n_bits, group)
    y = x.float() @ w_q.float()
    return (y * scale[None, :]).to(x.dtype)


def bitplane_matmul_planewise_ref(
    x: torch.Tensor,
    planes: torch.Tensor,
    scale: torch.Tensor,
    n_bits: int,
    group: int = 1,
) -> torch.Tensor:
    """Second oracle following the TPU kernel's contraction order
    (digit-plane matmuls + offset correction)."""
    nd, k8, m = planes.shape
    dpb = 8 // group
    digit_mask = (1 << group) - 1
    x_r = prepare_x_ref(x, group).float()
    acc = torch.zeros((x.shape[0], m), dtype=torch.float32, device=x.device)
    for j in range(nd):
        for r in range(dpb):
            digits = ((planes[j] >> (group * r)) & digit_mask).float()
            acc = acc + float(2 ** (group * j)) * (x_r[r] @ digits)
    off = float(2 ** (n_bits - 1))
    acc = acc - off * x.float().sum(dim=1, keepdim=True)
    return (acc * scale[None, :]).to(x.dtype)


def dequantize_ref(planes, scale, n_bits: int, group: int = 1):
    return unpack_ref(planes, n_bits, group).float() * scale[None, :]


# ---------------------------------------------------------------------------
# paged attention (K1, K2)
# ---------------------------------------------------------------------------

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
