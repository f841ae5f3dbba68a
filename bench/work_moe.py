"""The yardstick's arithmetic for a mixture of experts: K6's work and the
model FLOPs of a token that goes through `top_k` experts.

Frozen copies of the closed forms in `repro_torch/kernels/work.py` as they
stood when the first mixture-of-experts cell was added (the test
`bench/tests/test_bench_work_moe.py` holds them equal today), beside
`bench/work.py`'s peaks and bound. The benchmark computes work from the
shapes and lengths it knows and never calls the program's counter.
"""

from __future__ import annotations

from typing import Tuple

Work = Tuple[float, float]            # (FLOPs, bytes)


def k6_work(pairs: int, k: int, m: int, *, n_experts: int, n_bits: int = 8,
            group: int = 1, x_elt: int = 2) -> Tuple[float, float]:
    """K6 over `pairs` (token, expert) rows of a [K -> M] expert stack:
    FLOPs 2 * pairs * K * M; bytes the planes and f32 scales of the
    `min(E, pairs)` experts that can have rows, the pairs' x and their
    f32 output, each once."""
    nd = -(-n_bits // group)
    per_expert = nd * (k * group // 8) * m + 4 * m
    nbytes = (min(n_experts, pairs) * per_expert + pairs * k * x_elt
              + pairs * m * 4)
    return 2.0 * pairs * k * m, float(nbytes)


def _global_layers(model: dict) -> int:
    """Layers attending over the whole sequence (`window_schedule`)."""
    n, r = model["n_layers"], model.get("local_global_ratio", 0)
    if r <= 0 or model.get("sliding_window", 0) <= 0:
        return n
    return sum(1 for l in range(n) if l % (r + 1) == r)


def moe_active_params(model: dict) -> int:
    """Matmul parameters one token goes through in one layer: the
    attention projections, the router and `top_k` routed experts (and a
    shared expert of `d_ff * n_shared_experts`)."""
    d, h, kv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // h
    f, e = model["d_ff"], model["n_experts"]
    shared = model.get("n_shared_experts", 0)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    return attn + d * e + (model["top_k"] + shared) * 3 * d * f


def moe_token_flops(model: dict) -> float:
    """2 x the active matmul parameters over every layer."""
    return 2.0 * model["n_layers"] * moe_active_params(model)


def moe_visible_pairs(model: dict, lo: int, hi: int) -> int:
    """(query, key) pairs of query positions [lo, hi) summed over the
    layers: the whole prefix on global layers, the window on the
    others."""
    glob = _global_layers(model)
    local = model["n_layers"] - glob
    full = hi * (hi + 1) // 2 - lo * (lo + 1) // 2
    w = model.get("sliding_window", 0)
    windowed = 0
    if local:
        c = min(hi, w)
        windowed = (c * (c + 1) // 2 - lo * (lo + 1) // 2 if c > lo else 0)
        windowed += (hi - max(lo, c)) * w
    return glob * full + local * windowed


def moe_prefill_flops(model: dict, prompt: int) -> float:
    """A whole prompt: its tokens through the active parameters, its
    visible pairs at 4 * hd * H each, and one logits row."""
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    return (prompt * moe_token_flops(model)
            + 4.0 * hd * model["n_heads"] * moe_visible_pairs(model, 0,
                                                                prompt)
            + 2.0 * model["d_model"] * model["vocab_size"])


def moe_decode_flops(model: dict, visible: int) -> float:
    """One decoded token that sees `visible` keys (its own included) on a
    global layer, and at most the window on the others; its logits
    included."""
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    return (moe_token_flops(model)
            + 4.0 * hd * model["n_heads"] * moe_visible_pairs(
                model, visible - 1, visible)
            + 2.0 * model["d_model"] * model["vocab_size"])
