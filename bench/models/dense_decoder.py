"""Dense decoder-only transformers (the qwen2 / granite lineage): the
benchmark's weight maker and its plain reference.

`make_params` draws a configuration's weights from the seed on the device,
one call per stacked leaf, in the dtype they are served in, and lays them
out as the tree `repro_torch.models` serves from: layer leaves stacked
`[L, ...]` under "layers", projections `[fan_in, fan_out]`, norm gains in
f32. The benchmark hands the same tree to the program and, drawn again
from the same seed, to the reference.

`reference_logits` is the model written out in plain PyTorch, in f32
(TF32 off), with no cache, no batching and no kernel: pre-norm RMSNorm
blocks, GQA attention with rotary positions (the rotate-half form,
frequencies theta^(-2i/hd)) and an optional QKV bias, a SwiGLU or a plain
two-matrix MLP (GELU, tanh form). Where the configuration serves bit-plane
weights it quantizes each projection itself, as the serving set-up does
(symmetric per output column, scale = absmax / (2^(b-1) - 1) rounded to
the weight's dtype, codes rounded half to even), and multiplies by the
dequantized codes. `weights` / `acts` lower the precision for the control:
per-column weight codes and per-row activation codes at every
projection's input, in "int<b>" or "fp8" (e4m3).

It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: the spread of the drawn weights: fan-in projections 1/sqrt(K), biases,
#: embeddings and the output head, and the norm gains around 1
BIAS_STD = 0.1
EMBED_STD = 0.02
GAIN_STD = 0.1


def head_dim(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["n_heads"]


def _leaf_shapes(model: dict) -> List[tuple]:
    """`((group, name), shape, fan_in)` of every stacked layer leaf, in
    draw order; a bias has no fan-in."""
    d, h, kv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd, f = head_dim(model), model["d_ff"]
    out = [(("attn", "wq"), (d, h * hd), d), (("attn", "wk"), (d, kv * hd), d),
           (("attn", "wv"), (d, kv * hd), d), (("attn", "wo"), (h * hd, d), h * hd)]
    if model.get("qkv_bias"):
        out += [(("attn", "bq"), (h * hd,), None), (("attn", "bk"), (kv * hd,), None),
                (("attn", "bv"), (kv * hd,), None)]
    if model.get("mlp_kind", "swiglu") == "plain":
        out += [(("mlp", "w_up"), (d, f), d), (("mlp", "w_down"), (f, d), f)]
    else:
        out += [(("mlp", "w_gate"), (d, f), d), (("mlp", "w_up"), (d, f), d),
                (("mlp", "w_down"), (f, d), f)]
    return out


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
        std = BIAS_STD if fan_in is None else 1.0 / math.sqrt(fan_in)
        layers.setdefault(group, {})[name] = draw((n,) + shape, std)
    for norm in ("ln1", "ln2"):
        layers[norm] = {"g": draw((n, d), GAIN_STD, torch.float32).add_(1.0)}
    params = {
        "embed": draw((v, d), EMBED_STD),
        "layers": layers,
        "final_norm": {"g": draw((d,), GAIN_STD, torch.float32).add_(1.0)},
    }
    if not model.get("tie_embeddings", True):
        params["lm_head"] = draw((d, v), EMBED_STD)
    return params


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


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, hd] at positions `pos` [S]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = pos[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _gelu_tanh(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


_ACTS = {"silu": torch.nn.functional.silu, "gelu": _gelu_tanh}

#: query rows per block of the causal attention
_Q_BLOCK = 512


def _attention(q, k, v, n_kv):
    """Causal softmax attention, f32. q [S, H, hd], k / v [S, KV, hd];
    query head h reads K/V head h // (H / KV)."""
    s, h, hd = q.shape
    g = h // n_kv
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)      # [H, S, hd]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    keys = torch.arange(s, device=q.device)
    for a in range(0, s, _Q_BLOCK):
        b = min(a + _Q_BLOCK, s)
        sc = torch.einsum("qhd,hkd->hqk", q[a:b], k[:, :b]) * hd ** -0.5
        mask = keys[None, :b] > torch.arange(a, b, device=q.device)[:, None]
        sc = sc.masked_fill(mask[None], float("-inf"))
        out[a:b] = torch.einsum("hqk,hkd->qhd", torch.softmax(sc, -1),
                                v[:, :b])
    return out


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
    theta = model.get("rope_theta", 10_000.0)
    act = _ACTS[model.get("act", "silu")]
    plain = model.get("mlp_kind", "swiglu") == "plain"
    lay = params["layers"]
    xs = [params["embed"][s.long()].float() for s in sequences]
    pos = [torch.arange(s.shape[0], device=s.device) for s in sequences]
    for l in range(model["n_layers"]):
        def lin(group, name):
            return _Linear(lay[group][name][l], weights, acts)
        wq, wk, wv, wo = (lin("attn", n) for n in ("wq", "wk", "wv", "wo"))
        bias = {n: lay["attn"][n][l].float() for n in ("bq", "bk", "bv")
                if n in lay["attn"]}
        mlp = {n: lin("mlp", n) for n in lay["mlp"]}
        g1, g2 = lay["ln1"]["g"][l].float(), lay["ln2"]["g"][l].float()
        for i, x in enumerate(xs):
            a = _rmsnorm(x, g1, eps)
            q, k, v = wq(a), wk(a), wv(a)
            if bias:
                q, k, v = q + bias["bq"], k + bias["bk"], v + bias["bv"]
            s = x.shape[0]
            q = _rope(q.reshape(s, h, hd), pos[i], theta)
            k = _rope(k.reshape(s, kv, hd), pos[i], theta)
            att = _attention(q, k, v.reshape(s, kv, hd), kv)
            x = x + wo(att.reshape(s, h * hd))
            m = _rmsnorm(x, g2, eps)
            hid = (act(mlp["w_up"](m)) if plain
                   else act(mlp["w_gate"](m)) * mlp["w_up"](m))
            xs[i] = x + mlp["w_down"](hid)
        del wq, wk, wv, wo, mlp
    head = params.get("lm_head")
    head = (params["embed"].T if head is None else head).float()
    g = params["final_norm"]["g"].float()
    return [_rmsnorm(x[st:], g, eps) @ head for x, st in zip(xs, starts)]
