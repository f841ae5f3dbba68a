"""The yardstick's arithmetic: the chip's peaks, a model's FLOPs per token
and the work each kernel must do for given shapes.

These are frozen copies of the closed forms in `repro_torch/kernels/work.py`
as they stood when the benchmark was defined (the test
`bench/tests/test_bench_work.py` holds them equal today). They are the
benchmark's yardstick, not the program's: the benchmark computes work from
the shapes and lengths it knows and never calls the program's counter, so a
later change to the program cannot move the ruler it is measured with.

Counts take plain ints. Bytes are counted once per input read and once per
output written, whatever the kernel reads again.
"""

from __future__ import annotations

from typing import Iterable, Tuple

#: NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

Work = Tuple[float, float]            # (FLOPs, bytes)


def bound_s(work: Work) -> float:
    """The least time the chip could take for one launch: the larger of
    its operations over the peak rate and its bytes over the bandwidth."""
    flops, nbytes = work
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def _pages(lo: int, hi: int, bs: int) -> int:
    """Pages holding positions [lo, hi)."""
    return 0 if hi <= lo else -(-hi // bs) - lo // bs


def _keys_seen(lo: int, hi: int, window: int) -> int:
    """Sum over query positions [lo, hi) of min(pos + 1, window)."""
    if hi <= lo:
        return 0
    c = min(hi, window)
    n = c * (c + 1) // 2 - lo * (lo + 1) // 2 if c > lo else 0
    return n + (hi - max(lo, c)) * window


def k1_work(lengths: Iterable[int], *, n_heads: int, head_dim: int,
            n_kv: int, window: int, block_size: int, table_width: int,
            kv_elt: int = 2, q_elt: int = 2, scaled: bool = False) -> Work:
    """K1 (paged decode): one query per slot at `len - 1` sees
    `min(len, window)` keys. `lengths` holds every slot of the launch
    (an idle slot has length 1)."""
    lengths = list(lengths)
    b = len(lengths)
    rows = pages = 0
    for n in lengths:
        lo = max(n - int(window), 0)
        rows += n - lo
        pages += _pages(lo, n, block_size)
    kv_bytes = 2 * rows * n_kv * head_dim * kv_elt
    if scaled:
        kv_bytes += 2 * pages * n_kv * 4
    hh = b * n_heads * head_dim
    nbytes = (kv_bytes + hh * q_elt + hh * 4 + 4 * b * table_width
              + 4 * b + 4 * b)
    return 4.0 * head_dim * n_heads * rows, float(nbytes)


def k2_work(spans: Iterable[Tuple[int, int]], *, q_rows: int, n_heads: int,
            head_dim: int, n_kv: int, window: int, block_size: int,
            table_width: int, kv_elt: int = 2, q_elt: int = 2,
            scaled: bool = False) -> Work:
    """K2 (paged prefill): `spans` holds each slot's `(start, total)`; the
    launch carries `q_rows` (padded) suffix rows per slot, and suffix row
    t of a slot, at `start + t < total`, sees `min(start + t + 1,
    window)` keys."""
    spans = list(spans)
    b = len(spans)
    w = int(window)
    pairs = rows = pages = 0
    for s, tot in spans:
        end = min(tot, s + q_rows)
        pairs += _keys_seen(s, end, w)
        if end > s:
            lo = max(s - w + 1, 0)
            rows += tot - lo
            pages += _pages(lo, tot, block_size)
    kv_bytes = 2 * rows * n_kv * head_dim * kv_elt
    if scaled:
        kv_bytes += 2 * pages * n_kv * 4
    qh = b * q_rows * n_heads * head_dim
    nbytes = (kv_bytes + qh * q_elt + qh * 4 + 4 * b * table_width
              + 4 * b + 4 * b + 4 * b)
    return 4.0 * head_dim * n_heads * pairs, float(nbytes)


def bitplane_work(rows: int, k: int, m: int, *, n_bits: int = 8,
                  group: int = 1, x_elt: int = 2) -> Work:
    """K3 / K4: the dense [rows, K] @ [K, M] product they replace; bytes
    the digit planes, the f32 scale, x and y."""
    n_digits = -(-n_bits // group)
    planes = n_digits * (k * group // 8) * m
    nbytes = planes + 4 * m + rows * k * x_elt + rows * m * x_elt
    return 2.0 * rows * k * m, float(nbytes)


# ---------------------------------------------------------------------------
# model FLOPs (dense accounting, also for bit-plane weights)
# ---------------------------------------------------------------------------

def projections(model: dict) -> list:
    """The [K, M] of each projection of one layer, in the layer's order."""
    d, h, kv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // h
    f = model["d_ff"]
    shapes = [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d)]
    if model.get("mlp_kind", "swiglu") == "plain":
        shapes += [(d, f), (f, d)]
    else:
        shapes += [(d, f), (d, f), (f, d)]
    return shapes


def layer_matmul_params(model: dict) -> int:
    return sum(k * m for k, m in projections(model))


def token_flops(model: dict) -> float:
    """2 x the matmul parameters one token goes through in the layers."""
    return 2.0 * model["n_layers"] * layer_matmul_params(model)


def head_flops(model: dict) -> float:
    """The logits of one position: 2 x d_model x vocab."""
    return 2.0 * model["d_model"] * model["vocab_size"]


def attention_flops(model: dict, pairs: int) -> float:
    """4 * hd * H per visible (query, key) pair, in every layer."""
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    return 4.0 * hd * model["n_heads"] * pairs * model["n_layers"]


def prefill_flops(model: dict, prompt: int) -> float:
    """A whole prompt of `prompt` tokens, its one logits row included."""
    return (prompt * token_flops(model)
            + attention_flops(model, prompt * (prompt + 1) // 2)
            + head_flops(model))


def decode_flops(model: dict, visible: int) -> float:
    """One decoded token that sees `visible` keys, its logits included."""
    return (token_flops(model) + attention_flops(model, visible)
            + head_flops(model))
