"""Encoder-decoder backbone (whisper-medium): counterpart of
`repro.models.encdec`.

The conv / mel frontend is a stub, as in the reference: callers supply
frame embeddings [B, S_enc, D] (`frontend_stub.make_stub_embeddings`).
The backbone is real: a bidirectional encoder stack, and a causal
decoder stack with cross-attention whose encoder K/V the cache keeps.
Both stacks are stacked `[L, ...]` trees walked by a Python loop, as in
`models.transformer`; the decoder's self-attention caches and the cross
K/V are written in place. Every projection goes through `pim_linear`
with the caller's `impl`.

Under tensor parallelism (`dist.parallel`) the self- and cross-attention
and the MLPs are the dense stacks' column / row-parallel blocks; the
tied `embed`, split on d_model, is gathered at the embed hook and gives
the head's partial sums (`transformer._embed` / `_head`); the frames,
whose batch spec splits d_model too, are gathered at the encoder's
embed hook; the self K/V and the cross `xk` / `xv` are held in the
kv-heads layout of `launch.specs.cache_shardings` (`shard_cache`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..dist.parallel import pim_scales, row_linear
from ..dist.sharding import shard, tensor_parallel
from .attention import (
    attention_decode,
    attention_forward,
    attention_prefill,
    cross_attention_forward,
    cross_attention_kv,
    init_attention,
    init_cross_attention,
)
from .common import (
    Params,
    compute_dtype,
    embed_init,
    resolve_device,
    rmsnorm,
    rmsnorm_params,
)
from .mlp import init_mlp, mlp
from .transformer import (
    _embed,
    empty_stack,
    layer_params,
    remat,
    shard_cache,
    unstack_layers,
)


def _layer_shapes(cfg: ModelConfig, dtype):
    """The encoder's and the decoder's layer trees with a `(shape,
    dtype)` pair at each leaf: weights in `dtype`, norm gains f32."""
    d, f = cfg.d_model, cfg.d_ff
    width, kv_width = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    norm = {"g": ((d,), torch.float32)}

    def attn(kv):
        return {"wq": ((d, width), dtype), "wk": ((d, kv), dtype),
                "wv": ((d, kv), dtype), "wo": ((width, d), dtype)}
    mlp_shapes = {"w_up": ((d, f), dtype), "w_down": ((f, d), dtype)}
    enc = {"ln1": norm, "attn": attn(kv_width), "ln2": norm,
           "mlp": mlp_shapes}
    dec = {"ln1": norm, "attn": attn(kv_width), "ln_x": norm,
           "xattn": attn(width), "ln2": norm, "mlp": mlp_shapes}
    return enc, dec


def init_encdec(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", param_dtype: Optional[torch.dtype] = None
                ) -> Params:
    """Random parameters with the reference's tree: `enc_layers`,
    `enc_norm`, `dec_layers` (self-attention, cross-attention `xattn`,
    plain MLP), `dec_norm` and the tied `embed`. Weights in
    `param_dtype` (by default the compute dtype; training passes
    `torch.float32`, as `init_lm`), norm gains f32; drawn from
    `generator`, which must live on `device`. As in `init_lm`, each
    stacked `[L, ...]` leaf is allocated once and filled layer by layer
    (encoder layers, then decoder layers, then the embedding)."""
    dev = resolve_device(device)
    dt = compute_dtype(cfg.dtype) if param_dtype is None else param_dtype
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    enc_shapes, dec_shapes = _layer_shapes(cfg, dt)
    enc = empty_stack(enc_shapes, cfg.n_encoder_layers, dev)
    dec = empty_stack(dec_shapes, cfg.n_layers, dev)
    for l in range(cfg.n_encoder_layers):
        o = layer_params(enc, l)
        rmsnorm_params(d, dev, o["ln1"])
        init_attention(d, h, kv, hd, False, generator, dev, dt, o["attn"])
        rmsnorm_params(d, dev, o["ln2"])
        init_mlp(d, cfg.d_ff, generator, dev, dt, o["mlp"])
    for l in range(cfg.n_layers):
        o = layer_params(dec, l)
        rmsnorm_params(d, dev, o["ln1"])
        init_attention(d, h, kv, hd, False, generator, dev, dt, o["attn"])
        rmsnorm_params(d, dev, o["ln_x"])
        init_cross_attention(d, h, hd, generator, dev, dt, o["xattn"])
        rmsnorm_params(d, dev, o["ln2"])
        init_mlp(d, cfg.d_ff, generator, dev, dt, o["mlp"])
    return {
        "enc_layers": enc,
        "enc_norm": rmsnorm_params(d, dev),
        "dec_layers": dec,
        "dec_norm": rmsnorm_params(d, dev),
        "embed": embed_init(cfg.vocab_size, d, generator, dev, dt),
    }


def _attn_kwargs(cfg: ModelConfig):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.hd, rope_theta=cfg.rope_theta)


def _parallel_params(params: Params, cfg: ModelConfig) -> Params:
    """Under tensor parallelism, each stack's `PimWeight` scales brought to
    their planes' columns (`dist.parallel.pim_scales`; a tree already
    brought there passes unchanged)."""
    if tensor_parallel() is None:
        return params
    return dict(params,
                enc_layers=pim_scales(params["enc_layers"],
                                      cfg.n_encoder_layers),
                dec_layers=pim_scales(params["dec_layers"], cfg.n_layers))


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig,
           impl: str = "auto") -> torch.Tensor:
    """frames [B, S_enc, D] stub embeddings -> encoder states, through
    bidirectional attention."""
    params = _parallel_params(params, cfg)
    x = frames.to(compute_dtype(cfg.dtype))
    x = shard(x, "batch", "seq", "embed",
              src_dim=2 if x.shape[-1] < cfg.d_model else None)
    positions = torch.arange(x.shape[1], device=x.device)
    layers = unstack_layers(params["enc_layers"], cfg.n_encoder_layers)

    def body(x, l):
        lp = layers[l]
        x = x + attention_forward(
            lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), positions,
            causal=False, impl=impl, **_attn_kwargs(cfg))
        return x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps),
                       "gelu", impl, d_ff=cfg.d_ff)

    body = remat(cfg, body)
    for l in range(cfg.n_encoder_layers):
        x = body(x, l)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _cross_and_mlp(lp, x, xk, xv, cfg, impl):
    """The decoder layer after its self-attention: cross-attention over
    the encoder's K/V, then the GELU MLP."""
    x = x + cross_attention_forward(
        lp["xattn"], rmsnorm(lp["ln_x"], x, cfg.norm_eps), xk, xv,
        cfg.n_heads, cfg.hd, impl)
    return x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps), "gelu",
                   impl, d_ff=cfg.d_ff)


def _dec_block(lp, x, positions, enc_k, enc_v, cfg, impl="auto"):
    x = x + attention_forward(
        lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), positions,
        impl=impl, **_attn_kwargs(cfg))
    return _cross_and_mlp(lp, x, enc_k, enc_v, cfg, impl)


def _dec_head(params, x, cfg):
    """Logits through the tied `embed` (row-parallel where it holds a
    block of d_model)."""
    x = rmsnorm(params["dec_norm"], x, cfg.norm_eps)
    return row_linear(x, params["embed"].T.to(x.dtype), cfg.d_model)


def forward_encdec(params: Params, frames: torch.Tensor,
                   tokens: torch.Tensor, cfg: ModelConfig,
                   impl: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """Training forward: encode the frames, decode the tokens with
    teacher forcing. Returns (logits [B, T, V], {"moe_aux": 0.0}). Each
    encoder and decoder layer body is rematerialised in the backward
    when `cfg.remat` is set."""
    params = _parallel_params(params, cfg)
    enc_out = encode(params, frames, cfg, impl)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    layers = unstack_layers(params["dec_layers"], cfg.n_layers)

    def body(x, l):
        lp = layers[l]
        k, v = cross_attention_kv(lp["xattn"], enc_out, cfg.n_heads, cfg.hd,
                                  impl)
        return _dec_block(lp, x, positions, k, v, cfg, impl)

    body = remat(cfg, body)
    for l in range(cfg.n_layers):
        x = body(x, l)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _dec_head(params, x, cfg), {"moe_aux": aux}


def init_encdec_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      enc_len: int, device="cuda") -> Dict:
    """Zero self-attention K/V `[L, B, cache_len, KV, hd]` and cross K/V
    `[L, B, enc_len, H, hd]` in the compute dtype (each rank's blocks
    under tensor parallelism); write position 0 (a host int)."""
    dev = resolve_device(device)
    dt = compute_dtype(cfg.dtype)
    l = cfg.n_layers
    kv = (l, batch, cache_len, cfg.n_kv_heads, cfg.hd)
    xkv = (l, batch, enc_len, cfg.n_heads, cfg.hd)
    return shard_cache({
        "position": 0,
        "k": torch.zeros(kv, dtype=dt, device=dev),
        "v": torch.zeros(kv, dtype=dt, device=dev),
        "xk": torch.zeros(xkv, dtype=dt, device=dev),
        "xv": torch.zeros(xkv, dtype=dt, device=dev),
    })


def prefill_encdec(params: Params, frames: torch.Tensor,
                   tokens: torch.Tensor, cfg: ModelConfig, cache_len: int,
                   impl: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """Encode the frames, run the decoder prompt [B, T] into a new cache
    (self K/V in rows [0, T), each layer's cross K/V, position T) and
    return the logits [B, 1, V] of position T-1."""
    params = _parallel_params(params, cfg)
    enc_out = encode(params, frames, cfg, impl)
    b, t = tokens.shape
    cache = init_encdec_cache(cfg, b, cache_len, enc_out.shape[1],
                              enc_out.device)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(t, device=x.device)
    for l in range(cfg.n_layers):
        lp = layer_params(params["dec_layers"], l)
        xk, xv = cross_attention_kv(lp["xattn"], enc_out, cfg.n_heads,
                                    cfg.hd, impl)
        x = x + attention_prefill(
            lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), positions,
            cache["k"][l], cache["v"][l], impl=impl, **_attn_kwargs(cfg))[0]
        x = _cross_and_mlp(lp, x, xk, xv, cfg, impl)
        cache["xk"][l] = xk
        cache["xv"][l] = xv
    cache["position"] = t
    return _dec_head(params, x[:, -1:], cfg), cache


def decode_step_encdec(params: Params, token: torch.Tensor, cache: Dict,
                       cfg: ModelConfig, impl: str = "auto"
                       ) -> Tuple[torch.Tensor, Dict]:
    """One decoder token per row [B, 1] at the cache's position; the
    self-attention K/V are written in place. Returns (logits [B, 1, V],
    the cache at position + 1)."""
    params = _parallel_params(params, cfg)
    x = _embed(params, token, cfg)
    pos = cache["position"]
    for l in range(cfg.n_layers):
        lp = layer_params(params["dec_layers"], l)
        x = x + attention_decode(
            lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), pos,
            cache["k"][l], cache["v"][l], impl=impl, **_attn_kwargs(cfg))[0]
        x = _cross_and_mlp(lp, x, cache["xk"][l], cache["xv"][l], cfg, impl)
    return _dec_head(params, x, cfg), dict(cache, position=pos + 1)
