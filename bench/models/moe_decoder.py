"""Decoder-only mixtures of experts with windowed and YaRN layers (the
Mellum2 lineage): the benchmark's weight maker and its plain reference.

`make_params` draws a configuration's weights from the seed on the
device, one call per stacked leaf, in the dtype they are served in, and
lays them out as the tree `repro_torch.models` serves from: layer leaves
stacked `[L, ...]` under "layers", attention projections `[fan_in,
fan_out]` under "attn", the router `[L, d, E]` (f32) and the expert
stacks `[L, E, fan_in, fan_out]` under "moe", norm gains in f32. The
benchmark hands the same tree to the program and, drawn again from the
same seed, to the reference.

`reference_logits` is the model written out in plain PyTorch, in f32
(TF32 off), with no cache, no batching and no kernel:

  * pre-norm RMSNorm blocks; GQA attention, causal, in query blocks of
    `_Q_BLOCK` rows so a 4,608-position sequence fits beside the served
    model's leftovers; on a windowed layer (`local_global_ratio` r:
    every layer but each (r+1)-th) a query sees its last
    `sliding_window` positions, itself included;
  * rotary positions in the rotate-half form, frequencies
    theta^(-2i/d); on the global layers, where `yarn_factor` is set,
    YaRN: `extrap * gamma + extrap / factor * (1 - gamma)`, gamma = 1 -
    clamp((i - low) / (high - low), 0, 1), low = floor(d ln(orig / (2 pi
    beta_fast)) / (2 ln theta)) and high the ceiling at beta_slow, both
    in [0, d - 1]; cos and sin times `yarn_attention_factor`;
  * the mixture in every layer: router logits in f32, softmax over the
    experts, the top k (a stable sort: among equal probabilities the
    lower index first), gates renormalised to sum 1; every token's k
    experts computed (dropless), each a SwiGLU (silu(x Wg) * (x Wu)) Wd,
    and the k outputs added with their gates;
  * the untied head after a final RMSNorm.

Where the configuration serves bit-plane weights, each projection and
each expert's three matrices are quantized as the serving set-up does
(symmetric per output column, scale = absmax / (2^(b-1) - 1) rounded to
the weight's dtype, codes rounded half to even), and the reference
multiplies by the dequantized codes; the router, the embedding and the
head stay as drawn. `weights` / `acts` lower the precision for the
control: per-column weight codes and per-row activation codes at every
projection's input, in "int<b>" or "fp8" (e4m3).

It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: the spread of the drawn weights: fan-in projections 1/sqrt(K),
#: embeddings and the output head, and the norm gains around 1
EMBED_STD = 0.02
GAIN_STD = 0.1

#: query rows per block of the causal attention
_Q_BLOCK = 512


def head_dim(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["n_heads"]


def _leaf_shapes(model: dict) -> List[tuple]:
    """`((group, name), shape, fan_in)` of every stacked layer leaf, in
    draw order."""
    d, h, kv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd, f, e = head_dim(model), model["d_ff"], model["n_experts"]
    return [(("attn", "wq"), (d, h * hd), d), (("attn", "wk"), (d, kv * hd), d),
            (("attn", "wv"), (d, kv * hd), d),
            (("attn", "wo"), (h * hd, d), h * hd),
            (("moe", "we_gate"), (e, d, f), d), (("moe", "we_up"), (e, d, f), d),
            (("moe", "we_down"), (e, f, d), f)]


def make_params(model: dict, seed: int, device) -> dict:
    """The configuration's weights drawn from `seed` on `device`."""
    dt = _DTYPES[model.get("dtype", "bfloat16")]
    n, d, v = model["n_layers"], model["d_model"], model["vocab_size"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, std, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            0.0, std, generator=gen)

    layers: dict = {}
    for (group, name), shape, fan_in in _leaf_shapes(model):
        layers.setdefault(group, {})[name] = draw((n,) + shape,
                                                  1.0 / math.sqrt(fan_in))
    layers["moe"]["router"] = draw((n, d, model["n_experts"]),
                                   1.0 / math.sqrt(d), torch.float32)
    for norm in ("ln1", "ln2"):
        layers[norm] = {"g": draw((n, d), GAIN_STD, torch.float32).add_(1.0)}
    return {
        "embed": draw((v, d), EMBED_STD),
        "layers": layers,
        "final_norm": {"g": draw((d,), GAIN_STD, torch.float32).add_(1.0)},
        "lm_head": draw((d, v), EMBED_STD),
    }


# ---------------------------------------------------------------------------
# the plain reference
# ---------------------------------------------------------------------------

def _codes(x: torch.Tensor, fmt: str, dim: int) -> torch.Tensor:
    """`x` through symmetric codes of format `fmt` ("int<b>" or "fp8", the
    e4m3 format) with one scale per slice along `dim`, back in f32."""
    amax = x.abs().amax(dim=dim, keepdim=True)
    if fmt == "fp8":
        scale = (amax.float() / 448.0).clamp_min(1e-30)
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    qmax = float(2 ** (int(fmt[3:]) - 1) - 1)
    scale = torch.where(amax > 0, amax / qmax, 1.0).float()
    return torch.clamp(torch.round(x / scale), -(qmax + 1), qmax) * scale


def quantize_columns(w: torch.Tensor, fmt: str) -> torch.Tensor:
    """`w` [K, M] through per-column codes: for "int<b>" the serving
    set-up's scheme (scale = absmax / (2^(b-1) - 1), in w's dtype)."""
    return _codes(w, fmt, 0)


def quantize_rows(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """`x` [..., K] through per-row codes."""
    return _codes(x, fmt, -1)


class _Linear:
    """One projection as the reference computes it."""

    def __init__(self, w: torch.Tensor, weights: Optional[str],
                 acts: Optional[str]):
        self.w = w.float() if weights is None else quantize_columns(w, weights)
        self.acts = acts

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.acts is not None:
            x = quantize_rows(x, self.acts)
        return x @ self.w


def _rmsnorm(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def is_global(model: dict, l: int) -> bool:
    """Layer `l` attends over the whole prefix."""
    r = model.get("local_global_ratio", 0)
    if r <= 0 or model.get("sliding_window", 0) <= 0:
        return True
    return l % (r + 1) == r


def rope_tables(model: dict, l: int, pos: torch.Tensor):
    """cos and sin [S, 1, hd/2] of layer `l` at positions `pos` [S]."""
    hd = head_dim(model)
    half = hd // 2
    theta = model.get("rope_theta", 10_000.0)
    i = torch.arange(half, dtype=torch.float32, device=pos.device)
    freqs = 1.0 / theta ** (i / half)
    scale = 1.0
    factor = model.get("yarn_factor", 0.0)
    if factor > 0 and is_global(model, l):
        orig = model["yarn_original_context"]

        def dim(beta):
            return hd * math.log(orig / (beta * 2 * math.pi)) / (
                2 * math.log(theta))
        low = max(math.floor(dim(model.get("yarn_beta_fast", 32.0))), 0)
        high = min(math.ceil(dim(model.get("yarn_beta_slow", 1.0))), hd - 1)
        high = high if high != low else high + 0.001
        gamma = 1.0 - torch.clamp((i - low) / (high - low), 0.0, 1.0)
        freqs = freqs * gamma + (freqs / factor) * (1.0 - gamma)
        scale = model.get("yarn_attention_factor", 1.0)
    ang = pos[:, None].float() * freqs
    return (torch.cos(ang)[:, None, :] * scale,
            torch.sin(ang)[:, None, :] * scale)


def _rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x [S, heads, hd]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, n_kv, window: Optional[int]):
    """Causal softmax attention, f32. q [S, H, hd], k / v [S, KV, hd];
    query head h reads K/V head h // (H / KV); with `window`, a query at
    p sees keys (p - window, p]."""
    s, h, hd = q.shape
    g = h // n_kv
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)      # [H, S, hd]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    keys = torch.arange(s, device=q.device)
    for a in range(0, s, _Q_BLOCK):
        b = min(a + _Q_BLOCK, s)
        lo = 0 if window is None else max(a - window + 1, 0)
        sc = torch.einsum("qhd,hkd->hqk", q[a:b], k[:, lo:b]) * hd ** -0.5
        qpos = torch.arange(a, b, device=q.device)[:, None]
        kpos = keys[None, lo:b]
        mask = kpos > qpos
        if window is not None:
            mask = mask | (kpos <= qpos - window)
        sc = sc.masked_fill(mask[None], float("-inf"))
        out[a:b] = torch.einsum("hqk,hkd->qhd", torch.softmax(sc, -1),
                                v[:, lo:b])
    return out


def route(logits: torch.Tensor, top_k: int):
    """f32 logits [N, E] -> (gates [N, k], experts [N, k])."""
    probs = torch.softmax(logits.float(), dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = srt.values[:, :top_k], srt.indices[:, :top_k]
    return gates / gates.sum(-1, keepdim=True).clamp(min=1e-9), idx


def _experts(m: torch.Tensor, moe: dict, l: int, top_k: int, weights,
             acts) -> torch.Tensor:
    """The dropless mixture of layer `l` over the normed rows m [N, D]."""
    gates, idx = route(m @ moe["router"][l].float(), top_k)
    y = torch.zeros_like(m)
    for e in range(moe["we_gate"].shape[1]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = m[tok]
        wg, wu, wd = (_Linear(moe[n][l, e], weights, acts)
                      for n in ("we_gate", "we_up", "we_down"))
        out = wd(torch.nn.functional.silu(wg(xe)) * wu(xe))
        y.index_add_(0, tok, gates[tok, slot][:, None] * out)
    return y


@torch.no_grad()
def reference_logits(params: dict, model: dict,
                     sequences: Sequence[torch.Tensor],
                     starts: Sequence[int], *,
                     served: Optional[str] = None,
                     weights: Optional[str] = None,
                     acts: Optional[str] = None) -> List[torch.Tensor]:
    """f32 logits of each sequence at positions `starts[i]` and after:
    `[len(seq) - start, vocab]` per sequence. Layer by layer over all
    sequences, so one layer's f32 weights are alive at a time.

    `served`: the format the configuration serves its projections in
    ("int8" for 8-bit planes; None for its dtype); `weights` / `acts`
    (the control) lower the projections' weights and inputs further."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(params, model, sequences, starts,
                        weights or served, acts)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _forward(params, model, sequences, starts, weights, acts):
    h, kv, hd = model["n_heads"], model["n_kv_heads"], head_dim(model)
    eps = model.get("norm_eps", 1e-5)
    lay = params["layers"]
    xs = [params["embed"][s.long()].float() for s in sequences]
    pos = [torch.arange(s.shape[0], device=s.device) for s in sequences]
    sizes = [x.shape[0] for x in xs]
    for l in range(model["n_layers"]):
        wq, wk, wv, wo = (_Linear(lay["attn"][n][l], weights, acts)
                          for n in ("wq", "wk", "wv", "wo"))
        g1, g2 = lay["ln1"]["g"][l].float(), lay["ln2"]["g"][l].float()
        window = None if is_global(model, l) else model["sliding_window"]
        for i, x in enumerate(xs):
            a = _rmsnorm(x, g1, eps)
            s = x.shape[0]
            cos, sin = rope_tables(model, l, pos[i])
            q = _rope(wq(a).reshape(s, h, hd), cos, sin)
            k = _rope(wk(a).reshape(s, kv, hd), cos, sin)
            att = _attention(q, k, wv(a).reshape(s, kv, hd), kv, window)
            xs[i] = x + wo(att.reshape(s, h * hd))
        del wq, wk, wv, wo
        x_all = torch.cat(xs)
        y = _experts(_rmsnorm(x_all, g2, eps), lay["moe"], l, model["top_k"],
                     weights, acts)
        xs = list(torch.split(x_all + y, sizes))
    head = params["lm_head"].float()
    g = params["final_norm"]["g"].float()
    return [_rmsnorm(x[st:], g, eps) @ head for x, st in zip(xs, starts)]
