"""The unified decoder-only LM: counterpart of `repro.models.transformer`
— attention layers whose FFN is a SwiGLU, a plain MLP (granite) or a
mixture of experts (phi3.5-moe, llama4-scout); Mamba2 layers with a
weight-shared attention block after every `attn_every`-th (zamba2);
and xLSTM layers that hold both an mLSTM and an sLSTM cell, the sLSTM
running at every `slstm_every`-th layer (xlstm). A modality stub's
embeddings (llava) are prepended to the text through `extra_embeds`.

Entry points, as in the reference:

    forward(params, tokens, cfg, extra_embeds)   -> (logits, aux)
    prefill(params, tokens, cfg, cache_len, extra_embeds, last_pos)
                                                 -> (logits, cache)
    decode_step(params, token, cache, cfg)       -> (logits, cache)
    prefill_paged / decode_step_paged            (block-paged pools,
                                                  attention stacks only)

Parameters keep the reference's tree: layer parameters stacked as
`[L, ...]` under "layers" (zamba2's shared block under "shared"). The
reference scans the stack with `lax.scan` (and picks xLSTM's cell with
`lax.cond`); here a Python loop walks the layers, and each layer's
parameters, caches, states and pools are views `stack[l]`, so the
in-place writes of a layer land in the stacked tensors.

The dense cache holds `"position"`, a host int: one write position
shared by every row, so a decode step reads nothing back from the
device to place its KV. Beside it, by block kind:
  attn   "k", "v"       [L, B, S, KV, hd]  compute dtype
  mamba  "ssm"          [L, B, H, P, N]    f32
         "conv"         [L, B, d_conv - 1, conv_dim]  compute dtype
         "shared_k/v"   [sites, B, S, KV, hd]  the shared block's KV
  xlstm  "C", "n", "m"  mLSTM states, [L, B, ...] f32
         "sc", "sn", "sm", "sh"  sLSTM states, [L, B, D] f32
A layer whose xLSTM cell does not run leaves the other cell's state
untouched, as the reference's `lax.cond` passes it through.

Under tensor parallelism (`dist.parallel`) every stack computes on each
rank's blocks; the cache holds each rank's blocks too (`shard_cache`):
the K/V heads the rules split, and the recurrent states split as the
reference's `cache_shardings` splits them, which a decode step gathers
whole (`_read_state`) and writes back in blocks (`_write_state`). The
paged entry points run on one rank only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from ..dist import collectives
from ..dist.parallel import (
    enter,
    gather_state,
    pim_scales,
    row_linear,
    state_block,
    whole_logits,
)
from ..dist.sharding import (
    STATE_DIMS,
    TensorParallelUnsupported,
    current_context,
    shard,
    state_model_dim,
    tensor_parallel,
    within,
)
from ..kernels.ops import is_bucket_plan
from ..quant.bitplane import PimWeight
from .attention import (
    attention_decode,
    attention_decode_paged,
    attention_forward,
    attention_prefill,
    attention_prefill_paged,
    decode_mask,
    decode_position,
    init_attention,
)
from .common import (
    Params,
    compute_dtype,
    embed_init,
    resolve_device,
    rmsnorm,
    rmsnorm_params,
)
from .mamba2 import (
    conv_dim,
    init_mamba2,
    mamba2_decode,
    mamba2_forward,
    mamba2_shapes,
)
from .mlp import init_mlp, init_swiglu, mlp, swiglu
from .moe import init_moe, moe_forward
from .xlstm import (
    init_mlstm,
    init_slstm,
    mlstm_decode,
    mlstm_forward,
    mlstm_init_state,
    mlstm_shapes,
    slstm_decode,
    slstm_forward,
    slstm_init_state,
    slstm_shapes,
)

#: the xLSTM cache's mLSTM and sLSTM state keys, and each one's name in
#: its cell's state tree
_MLSTM_KEYS = (("C", "C"), ("n", "n"), ("m", "m"))
_SLSTM_KEYS = (("sc", "c"), ("sn", "n"), ("sm", "m"), ("sh", "h"))


def _require_attention(cfg: ModelConfig, what: str) -> None:
    if cfg.block_kind != "attn":
        raise ValueError(f"{what} supports attention stacks only")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(cfg: ModelConfig, generator, device, dtype,
               out: Optional[Params] = None) -> Params:
    """One layer's parameters, drawn from `generator` in a fixed order.
    With `out` (a tree of preallocated tensors of the same shapes, e.g.
    `layer_params(stacked, l)`) the draws are written into it in place."""
    def o(name):
        return None if out is None else out[name]
    d = cfg.d_model
    if cfg.block_kind == "mamba":
        return {
            "ln1": rmsnorm_params(d, device, o("ln1")),
            "mamba": init_mamba2(d, cfg.d_inner, cfg.ssm_heads,
                                 cfg.ssm_state, cfg.ssm_conv, generator,
                                 device, dtype, o("mamba")),
        }
    if cfg.block_kind == "xlstm":
        return {
            "ln1": rmsnorm_params(d, device, o("ln1")),
            "mlstm": init_mlstm(d, cfg.n_heads, cfg.ssm_expand, generator,
                                device, dtype, o("mlstm")),
            "ln_s": rmsnorm_params(d, device, o("ln_s")),
            "slstm": init_slstm(d, cfg.n_heads, generator, device, dtype,
                                o("slstm")),
        }
    if cfg.block_kind != "attn":
        raise ValueError(cfg.block_kind)
    p: Params = {
        "ln1": rmsnorm_params(d, device, o("ln1")),
        "attn": init_attention(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.qkv_bias,
            generator, device, dtype, o("attn"),
        ),
        "ln2": rmsnorm_params(d, device, o("ln2")),
    }
    if cfg.n_experts:
        p["moe"] = init_moe(d, cfg.d_ff, cfg.n_experts,
                            cfg.n_shared_experts, generator, device, dtype,
                            o("moe"))
    elif cfg.mlp_kind == "plain":
        p["mlp"] = init_mlp(d, cfg.d_ff, generator, device, dtype, o("mlp"))
    else:
        p["mlp"] = init_swiglu(d, cfg.d_ff, generator, device, dtype,
                               o("mlp"))
    return p


def _swiglu_shapes(d: int, f: int, dtype) -> Params:
    return {"w_gate": ((d, f), dtype), "w_up": ((d, f), dtype),
            "w_down": ((f, d), dtype)}


def layer_shapes(cfg: ModelConfig, dtype) -> Params:
    """`init_layer`'s tree with a `(shape, dtype)` pair at each leaf,
    from the config alone: weights and biases in `dtype`; in f32 the
    norm gains, the MoE router, Mamba2's conv, `A_log`, `D` and
    `dt_bias`, and the sLSTM's `r_gates` and `b_gates` — the leaves the
    reference keeps and applies in f32 (`b_gates` is cast at use, so
    either dtype would be exact)."""
    d, hd, f32 = cfg.d_model, cfg.hd, torch.float32
    norm = {"g": ((d,), f32)}
    if cfg.block_kind == "mamba":
        return {"ln1": norm,
                "mamba": mamba2_shapes(d, cfg.d_inner, cfg.ssm_heads,
                                       cfg.ssm_state, cfg.ssm_conv, dtype)}
    if cfg.block_kind == "xlstm":
        return {"ln1": norm,
                "mlstm": mlstm_shapes(d, cfg.n_heads, cfg.ssm_expand, dtype),
                "ln_s": norm,
                "slstm": slstm_shapes(d, cfg.n_heads, dtype)}
    if cfg.block_kind != "attn":
        raise ValueError(cfg.block_kind)
    attn = {
        "wq": ((d, cfg.n_heads * hd), dtype),
        "wk": ((d, cfg.n_kv_heads * hd), dtype),
        "wv": ((d, cfg.n_kv_heads * hd), dtype),
        "wo": ((cfg.n_heads * hd, d), dtype),
    }
    if cfg.qkv_bias:
        attn.update(bq=((cfg.n_heads * hd,), dtype),
                    bk=((cfg.n_kv_heads * hd,), dtype),
                    bv=((cfg.n_kv_heads * hd,), dtype))
    shapes: Params = {"ln1": norm, "attn": attn, "ln2": norm}
    f, e = cfg.d_ff, cfg.n_experts
    if e:
        moe = {"router": ((d, e), f32), "we_gate": ((e, d, f), dtype),
               "we_up": ((e, d, f), dtype), "we_down": ((e, f, d), dtype)}
        if cfg.n_shared_experts:
            moe["shared"] = _swiglu_shapes(d, f * cfg.n_shared_experts,
                                           dtype)
        shapes["moe"] = moe
    elif cfg.mlp_kind == "plain":
        shapes["mlp"] = {"w_up": ((d, f), dtype), "w_down": ((f, d), dtype)}
    else:
        shapes["mlp"] = _swiglu_shapes(d, f, dtype)
    return shapes


def empty_stack(tree: Params, n: int, device) -> Params:
    """Uninitialised `[n, ...]` leaves for a `layer_shapes` tree."""
    if isinstance(tree, dict):
        return {k: empty_stack(v, n, device) for k, v in tree.items()}
    shape, dtype = tree
    return torch.empty((n,) + shape, dtype=dtype, device=device)


def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device="cuda", param_dtype: Optional[torch.dtype] = None
            ) -> Params:
    """Random parameters with the reference's shapes and init scales
    (truncated-normal fan-in projections, N(0, 0.02) embeddings, zero
    biases, unit norm gains), drawn from `generator` — which must live
    on `device`. Weights are stored in `param_dtype`, by default the
    compute dtype (serving; the same once-cast `bridge.params_from_jax`
    applies), and the f32 leaves of `layer_shapes` in f32. Training
    passes `torch.float32`: the reference's f32 masters, each cast to
    the compute dtype where it is used. zamba2's shared attention block
    goes under "shared". An encoder-decoder config gets the decoder-only
    stack here, as the reference's `init_lm` gives it (`init_encdec`
    builds the encoder-decoder).

    Each stacked `[L, ...]` leaf is allocated once and filled layer by
    layer (draws in layer order, then the embedding), so the device
    holds the model plus one f32 draw at a time — never a second copy
    of the layer stack."""
    cfg.validate()
    dev = resolve_device(device)
    dt = compute_dtype(cfg.dtype) if param_dtype is None else param_dtype
    layers = empty_stack(layer_shapes(cfg, dt), cfg.n_layers, dev)
    for l in range(cfg.n_layers):
        init_layer(cfg, generator, dev, dt, out=layer_params(layers, l))
    params: Params = {
        "embed": embed_init(cfg.vocab_size, cfg.d_model, generator, dev, dt),
        "layers": layers,
        "final_norm": rmsnorm_params(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(cfg.d_model, cfg.vocab_size,
                                       generator, dev, dt)
    if cfg.attn_every > 0:
        params["shared"] = {
            "ln": rmsnorm_params(cfg.d_model, dev),
            "attn": init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, False, generator, dev, dt),
            "ln2": rmsnorm_params(cfg.d_model, dev),
            "mlp": init_swiglu(cfg.d_model, cfg.d_ff, generator, dev, dt),
        }
    return params


def count_params(params: Params) -> int:
    """Elements in the tree; a `PimWeight` counts its planes and scale,
    the leaves the reference's pytree flattens it to."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, PimWeight):
        return params.planes.numel() + params.scale.numel()
    return params.numel()


def layer_params(stacked: Params, l: int) -> Params:
    """Layer `l`'s parameter tree: views into the stacked tensors (a
    stacked `PimWeight` indexes to its layer's planes and scale)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, l) for k, v in stacked.items()}
    return stacked[l]


def unstack_layers(stacked: Params, n: int) -> List[Params]:
    """Every layer's parameter tree at once, as the layer loops walk
    them: views into the stacked tensors by `torch.unbind`, whose
    backward writes the layers' gradients into one stacked tensor —
    indexing each layer apart (`layer_params`) would give every layer a
    zero-filled gradient of the whole stack, summed L times. A stacked
    `PimWeight` indexes to its layers."""
    if isinstance(stacked, dict):
        per = {k: unstack_layers(v, n) for k, v in stacked.items()}
        return [{k: per[k][l] for k in per} for l in range(n)]
    if isinstance(stacked, torch.Tensor):
        return list(torch.unbind(stacked, 0))
    return [stacked[l] for l in range(n)]


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _embed(params, tokens, cfg, extra_embeds=None):
    """Token embeddings in the compute dtype, after the frontend stub's
    `extra_embeds` [B, T_front, D] when given. Under tensor parallelism
    `embed` holds a block of d_model (the reference's spec splits its
    last dimension), and the embed hook gathers the features; the stub's
    `extra_embeds` are brought to the same layout before the two are
    joined (whole from a serving caller; a training batch's spec splits
    their d_model too, and that block is gathered)."""
    dt = compute_dtype(cfg.dtype)
    x = params["embed"][tokens.long()].to(dt)
    src = 2 if x.shape[-1] < cfg.d_model else None
    x = shard(x, "batch", "seq", "embed", src_dim=src)
    if extra_embeds is not None:
        front = extra_embeds.to(dt)
        front = shard(front, "batch", "seq", "embed",
                      src_dim=2 if front.shape[-1] < cfg.d_model else None)
        x = torch.cat([front, x], dim=1)
    return x


def _head(params, x, cfg):
    """Logits [.., V], whole on every rank. Under tensor parallelism a
    split `lm_head` gives a vocab block, the logits hook's layout, which
    is gathered for the entry point's caller; the tied `embed.T` holds a
    block of d_model rows, whose partial sums are all-reduced."""
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if "lm_head" in params:
        w = params["lm_head"]
        logits = enter(x) @ w.to(x.dtype)
        logits = shard(logits, "batch", "seq", "vocab",
                       src_dim=2 if w.shape[-1] < cfg.vocab_size else None)
        return whole_logits(logits, cfg.vocab_size)
    return row_linear(x, params["embed"].T.to(x.dtype), cfg.d_model)


def _parallel_params(params, cfg: ModelConfig):
    """The params an entry point computes with: under tensor parallelism
    (a context whose mesh splits over ``model``) each `PimWeight`'s scale
    brought to its planes' columns (`dist.parallel.pim_scales`)."""
    if tensor_parallel() is None:
        return params
    return pim_scales(params, cfg.n_layers)


def _window_array(cfg: ModelConfig, seq_len: int) -> List[int]:
    return list(cfg.window_schedule(seq_len))


# ---------------------------------------------------------------------------
# layer loops
# ---------------------------------------------------------------------------

def _attn_kwargs(cfg: ModelConfig, l: Optional[int] = None):
    """The attention's keyword arguments; with layer `l`, that layer's
    rotary spec (`ModelConfig.layer_rope`: YaRN on global layers where
    the config sets it)."""
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.hd,
                rope_theta=cfg.rope_theta if l is None else cfg.layer_rope(l))


def _ssm_kwargs(cfg: ModelConfig):
    return dict(n_heads=cfg.ssm_heads, n_state=cfg.ssm_state,
                d_inner=cfg.d_inner)


def remat(cfg: ModelConfig, body):
    """A layer body `body(x, l)` under activation checkpointing when
    `cfg.remat` is set — the reference's `jax.checkpoint` of each layer
    body: the backward recomputes the layer from its input instead of
    keeping its activations. It applies only where autograd records the
    call (`x` requires grad), so serving and scoring run the plain body.
    The values are the same either way."""
    if not cfg.remat:
        return body

    def run(x, l):
        if not (torch.is_grad_enabled() and x.requires_grad):
            return body(x, l)
        ctx = current_context()

        def in_context(x, l):
            # the recompute runs on the autograd engine's thread for CUDA
            # tensors, which has no sharding context of its own
            with within(ctx):
                return body(x, l)
        return torch.utils.checkpoint.checkpoint(
            in_context, x, l, use_reentrant=False, preserve_rng_state=False)
    return run


def _ffn(lp, h, cfg, impl):
    """One layer's FFN on the normed `h`, as the reference's
    `_attn_block` / `_ffn` pick it: `(output, load-balance loss)`, the
    loss None for a dense FFN."""
    if cfg.n_experts:
        y, aux = moe_forward(lp["moe"], h, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor,
                             act=cfg.act, impl=impl,
                             shared_d_ff=cfg.d_ff * cfg.n_shared_experts)
        return y, aux["load_balance_loss"]
    if cfg.mlp_kind == "plain":
        return mlp(lp["mlp"], h, cfg.act, impl, d_ff=cfg.d_ff), None
    return swiglu(lp["mlp"], h, cfg.act, impl, d_ff=cfg.d_ff), None


def _layer_loop(params, x, cfg, windows, attn, impl):
    """The body of the reference's `lax.scan`s, one layer at a time:
    `attn(l, attn_params, normed_x, window)` gives layer `l`'s attention
    output, then the FFN. `impl` reaches every projection
    (`pim_linear`). Each layer body goes through `remat`. Returns
    `(x, losses)`: the MoE layers' load-balance losses in layer order
    (empty for a dense stack)."""
    layers = unstack_layers(params["layers"], cfg.n_layers)

    def body(x, l):
        lp = layers[l]
        x = x + attn(l, lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps),
                     windows[l])
        h, loss = _ffn(lp, rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg, impl)
        return x + h, loss

    body = remat(cfg, body)
    losses = []
    for l in range(cfg.n_layers):
        x, loss = body(x, l)
        if loss is not None:
            losses.append(loss)
    return x, losses


def _group_slices(cfg: ModelConfig):
    """zamba2's groups `[(lo, hi, has_attn), ...]`: `attn_every` layers
    each, a full group ending in the shared block; a shorter tail group
    has none."""
    ae, n = cfg.attn_every, cfg.n_layers
    if ae <= 0:
        return [(0, n, False)]
    return [(lo, min(lo + ae, n), min(lo + ae, n) - lo == ae)
            for lo in range(0, n, ae)]


def _mamba_loop(params, x, cfg, block, shared_attn, impl):
    """zamba2's stack: `block(l, mamba_params, normed_x)` gives Mamba2
    layer `l`'s output; after each full group the weight-shared block
    runs, its attention through `shared_attn(site, attn_params,
    normed_x)`, site counting the shared block's calls. Each Mamba2
    layer body goes through `remat` (the shared block does not, as in
    the reference)."""
    layers = unstack_layers(params["layers"], cfg.n_layers)

    def body(x, l):
        lp = layers[l]
        return x + block(l, lp["mamba"], rmsnorm(lp["ln1"], x, cfg.norm_eps))

    body = remat(cfg, body)
    site = 0
    for lo, hi, has_attn in _group_slices(cfg):
        for l in range(lo, hi):
            x = body(x, l)
        if has_attn and "shared" in params:
            sp = params["shared"]
            x = x + shared_attn(site, sp["attn"],
                                rmsnorm(sp["ln"], x, cfg.norm_eps))
            x = x + swiglu(sp["mlp"], rmsnorm(sp["ln2"], x, cfg.norm_eps),
                           cfg.act, impl, d_ff=cfg.d_ff)
            site += 1
    return x


def _xlstm_loop(params, x, cfg, mlstm, slstm):
    """xlstm's stack: the sLSTM cell where `layer_flags()["is_slstm"]`,
    the mLSTM elsewhere, as `mlstm(l, params, normed_x)` /
    `slstm(l, params, normed_x)` give them. Each layer body goes
    through `remat`."""
    flags = cfg.layer_flags()["is_slstm"]
    layers = unstack_layers(params["layers"], cfg.n_layers)

    def body(x, l):
        lp = layers[l]
        if flags[l]:
            return x + slstm(l, lp["slstm"], rmsnorm(lp["ln_s"], x,
                                                      cfg.norm_eps))
        return x + mlstm(l, lp["mlstm"], rmsnorm(lp["ln1"], x,
                                                  cfg.norm_eps))

    body = remat(cfg, body)
    for l in range(cfg.n_layers):
        x = body(x, l)
    return x


# ---------------------------------------------------------------------------
# full-sequence forward and the dense pre-allocated cache
# ---------------------------------------------------------------------------

def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            extra_embeds: Optional[torch.Tensor] = None,
            impl: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """Full-sequence logits [B, T_front + T, V] (training / scoring),
    windows from `window_schedule(T)`; aux `{"moe_aux": the sum of the
    MoE layers' load-balance losses}` (0.0 for a dense or recurrent
    stack). Each layer body is rematerialised in the backward when
    `cfg.remat` is set (`remat`)."""
    params = _parallel_params(params, cfg)
    x = _embed(params, tokens, cfg, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    losses = []
    if cfg.block_kind == "attn":
        def attn(l, p, h, window):
            return attention_forward(p, h, positions, window=window,
                                     impl=impl, **_attn_kwargs(cfg, l))
        x, losses = _layer_loop(params, x, cfg,
                                _window_array(cfg, x.shape[1]), attn, impl)
    elif cfg.block_kind == "mamba":
        x = _mamba_loop(
            params, x, cfg,
            lambda l, p, h: mamba2_forward(p, h, impl=impl,
                                           **_ssm_kwargs(cfg)),
            lambda site, p, h: attention_forward(
                p, h, positions, impl=impl, **_attn_kwargs(cfg)),
            impl)
    elif cfg.block_kind == "xlstm":
        x = _xlstm_loop(
            params, x, cfg,
            lambda l, p, h: mlstm_forward(p, h, n_heads=cfg.n_heads,
                                          impl=impl),
            lambda l, p, h: slstm_forward(p, h, n_heads=cfg.n_heads,
                                          impl=impl))
    else:
        raise ValueError(cfg.block_kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for loss in losses:
        aux = aux + loss
    return _head(params, x, cfg), {"moe_aux": aux}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> Dict:
    """Pre-allocated decode cache at write position 0: zero K/V `[L,
    batch, cache_len, KV, hd]` in the compute dtype for an attention
    stack; for zamba2 zero SSM states (f32), conv tails (compute dtype)
    and the shared block's K/V, one `[batch, cache_len, KV, hd]` slice
    per site; for xlstm both cells' initial states, f32, in every
    layer."""
    dev = resolve_device(device)
    dt = compute_dtype(cfg.dtype)
    l = cfg.n_layers
    cache: Dict = {"position": 0}
    if cfg.block_kind == "attn":
        shape = (l, batch, cache_len, cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
    for key, a in _layer_states(cfg, batch, dev).items():
        cache[key] = a[None].expand((l,) + tuple(a.shape)).clone()
    if cfg.block_kind == "mamba":
        n_sites = sum(1 for *_, has_attn in _group_slices(cfg) if has_attn)
        if n_sites:
            shape = (n_sites, batch, cache_len, cfg.n_kv_heads, cfg.hd)
            cache["shared_k"] = torch.zeros(shape, dtype=dt, device=dev)
            cache["shared_v"] = torch.zeros(shape, dtype=dt, device=dev)
    return shard_cache(cache)


def _layer_states(cfg: ModelConfig, batch: int, device) -> Dict:
    """One layer's initial recurrent states, whole, by cache key: zero
    Mamba2 `ssm` (f32) and `conv` tail (compute dtype); both xLSTM cells'
    initial states (f32); none for an attention stack."""
    if cfg.block_kind == "mamba":
        return {
            "ssm": torch.zeros((batch, cfg.ssm_heads,
                                cfg.d_inner // cfg.ssm_heads, cfg.ssm_state),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                                 conv_dim(cfg.d_inner, cfg.ssm_state)),
                                dtype=compute_dtype(cfg.dtype),
                                device=device)}
    if cfg.block_kind == "xlstm":
        hd = cfg.ssm_expand * cfg.d_model // cfg.n_heads
        out = {}
        for keys, state in (
                (_MLSTM_KEYS, mlstm_init_state(batch, cfg.n_heads, hd,
                                               device)),
                (_SLSTM_KEYS, slstm_init_state(batch, cfg.d_model, device))):
            out.update((key, state[name]) for key, name in keys)
        return out
    return {}


def shard_cache(cache: Dict) -> Dict:
    """A whole cache cut to this rank's blocks over ``model`` (no-op
    without a context, or where the layout keeps a leaf whole). The K/V
    leaves [L, B, S, KV, hd] are placed by the rules ("layers", "batch",
    "kv_seq", "kv_heads", "cache_head_dim"): `kv_seq` stays whole, as the
    port computes attention over the whole sequence. The recurrent states
    split on the dimension `sharding.state_model_dim` names, as the
    reference's `cache_shardings` lays them out. Rows are already this
    rank's (`batch` is the caller's). Prefill and decode write the placed
    tensors in place, so the reference's calls at their ends have no
    counterpart here."""
    ctx = tensor_parallel()
    out = {}
    for k, v in cache.items():
        if k in ("k", "v", "shared_k", "shared_v", "xk", "xv"):
            v = shard(v, "layers", "batch", "kv_seq", "kv_heads",
                      "cache_head_dim")
        elif ctx is not None and k in STATE_DIMS:
            d = state_model_dim(k, v.shape, ctx.model)
            if d is not None:
                v = collectives.scatter(v, "model", d)
        out[k] = v
    return out


def _read_state(cfg: ModelConfig, cache: Dict, key: str, l: int):
    """Layer `l`'s state `key`, whole (gathered where the cache holds this
    rank's block of it)."""
    held = cache[key][l]
    if tensor_parallel() is None:
        return held
    whole = _layer_states(cfg, held.shape[0], "meta")[key].shape
    return gather_state(held, whole)


def _write_state(cache: Dict, key: str, l: int, value) -> None:
    """Layer `l`'s whole new state `key` into the cache, in place: this
    rank's block of it where the cache holds one."""
    cache[key][l] = state_block(value, cache[key][l])


def _cache_len(cache: Dict, cfg: ModelConfig) -> int:
    if "k" in cache:
        return cache["k"].shape[2]
    if "shared_k" in cache:
        return cache["shared_k"].shape[2]
    return 1  # a purely recurrent stack has no positional cache


def _xlstm_cells(cfg: ModelConfig, cache: Dict, run_m, run_s, fresh: bool):
    """The xLSTM layer callables of `_xlstm_loop` over `cache`: each calls
    `run_m(params, h, state)` / `run_s(...)` -> `(y, new_state)` on its
    layer's whole state of the cell that runs (None with `fresh`: the
    cell's initial state, which a new cache holds) and writes the new
    state back in place; the other cell's state stays as it was."""
    def cell(keys, run):
        def fn(l, p, h):
            st = None if fresh else {
                name: _read_state(cfg, cache, key, l) for key, name in keys}
            y, st = run(p, h, st)
            for key, name in keys:
                _write_state(cache, key, l, st[name])
            return y
        return fn
    return cell(_MLSTM_KEYS, run_m), cell(_SLSTM_KEYS, run_s)


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            cache_len: int, extra_embeds: Optional[torch.Tensor] = None,
            last_pos=None, impl: str = "auto"
            ) -> Tuple[torch.Tensor, Dict]:
    """Process a [B, T] prompt (after `extra_embeds`' positions) into a
    new cache of `cache_len` rows (its KV in rows [0, T), zeros after,
    the recurrent states after T steps; position T) and return the
    logits [B, 1, V] of position T-1, or of `last_pos` — clamped into
    [0, T-1] as the reference's `dynamic_slice` clamps it. Windows come
    from `window_schedule(cache_len)`, as in the reference."""
    params = _parallel_params(params, cfg)
    x = _embed(params, tokens, cfg, extra_embeds)
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)
    cache = init_cache(cfg, b, cache_len, x.device)
    if cfg.block_kind == "attn":
        def attn(l, p, h, window):
            return attention_prefill(p, h, positions, cache["k"][l],
                                     cache["v"][l], window=window,
                                     impl=impl, **_attn_kwargs(cfg, l))[0]
        x = _layer_loop(params, x, cfg, _window_array(cfg, cache_len),
                        attn, impl)[0]
    elif cfg.block_kind == "mamba":
        def block(l, p, h):
            y, (ssm, conv) = mamba2_forward(
                p, h, return_state=True, impl=impl, **_ssm_kwargs(cfg))
            _write_state(cache, "ssm", l, ssm)
            _write_state(cache, "conv", l, conv)
            return y

        def shared(site, p, h):
            return attention_prefill(
                p, h, positions, cache["shared_k"][site],
                cache["shared_v"][site], impl=impl, **_attn_kwargs(cfg))[0]
        x = _mamba_loop(params, x, cfg, block, shared, impl)
    elif cfg.block_kind == "xlstm":
        x = _xlstm_loop(params, x, cfg, *_xlstm_cells(
            cfg, cache,
            lambda p, h, st: mlstm_forward(p, h, n_heads=cfg.n_heads,
                                           init_state=st, return_state=True,
                                           impl=impl),
            lambda p, h, st: slstm_forward(p, h, n_heads=cfg.n_heads,
                                           init_state=st, return_state=True,
                                           impl=impl), fresh=True))
    else:
        raise ValueError(cfg.block_kind)
    cache["position"] = t
    last = t - 1 if last_pos is None else min(max(int(last_pos), 0), t - 1)
    return _head(params, x[:, last: last + 1], cfg), cache


def decode_step(params: Params, token: torch.Tensor, cache: Dict,
                cfg: ModelConfig, impl: str = "auto"
                ) -> Tuple[torch.Tensor, Dict]:
    """One new token per row [B, 1] at the cache's shared position: the
    paper's GEMV workload. The tensors of `cache` (K/V, recurrent
    states) are written in place; the returned cache holds them and
    position + 1. Returns (logits [B, 1, V], cache)."""
    params = _parallel_params(params, cfg)
    x = _embed(params, token, cfg)
    pos, s = cache["position"], _cache_len(cache, cfg)
    rope_pos = decode_position(pos, x.device)
    if cfg.block_kind == "attn":
        windows = _window_array(cfg, s)
        masks = {w: decode_mask(pos, s, w, x.device) for w in set(windows)}

        def attn(l, p, h, window):
            return attention_decode(p, h, pos, cache["k"][l], cache["v"][l],
                                    window=window, impl=impl,
                                    rope_pos=rope_pos, mask=masks[window],
                                    **_attn_kwargs(cfg, l))[0]
        x = _layer_loop(params, x, cfg, windows, attn, impl)[0]
    elif cfg.block_kind == "mamba":
        mask = decode_mask(pos, s, None, x.device)

        def block(l, p, h):
            y, ssm, conv = mamba2_decode(
                p, h, _read_state(cfg, cache, "ssm", l),
                _read_state(cfg, cache, "conv", l), impl=impl,
                **_ssm_kwargs(cfg))
            _write_state(cache, "ssm", l, ssm)
            _write_state(cache, "conv", l, conv)
            return y

        def shared(site, p, h):
            return attention_decode(
                p, h, pos, cache["shared_k"][site], cache["shared_v"][site],
                impl=impl, rope_pos=rope_pos, mask=mask,
                **_attn_kwargs(cfg))[0]
        x = _mamba_loop(params, x, cfg, block, shared, impl)
    elif cfg.block_kind == "xlstm":
        x = _xlstm_loop(params, x, cfg, *_xlstm_cells(
            cfg, cache,
            lambda p, h, st: mlstm_decode(p, h, st, n_heads=cfg.n_heads,
                                          impl=impl),
            lambda p, h, st: slstm_decode(p, h, st, n_heads=cfg.n_heads,
                                          impl=impl), fresh=False))
    else:
        raise ValueError(cfg.block_kind)
    return _head(params, x, cfg), dict(cache, position=pos + 1)


# ---------------------------------------------------------------------------
# layer groups and paged pools
# ---------------------------------------------------------------------------

def layer_attn_groups(cfg: ModelConfig, capacity: int) -> list:
    """Partition the layer stack by attention pattern:
    `[(window, layers), ...]` with `window=None` for global layers
    (global groups first, then windowed ones by ascending window). The
    paged cache and the paged entry points both derive the partition
    from this one function."""
    groups: Dict[Optional[int], list] = {}
    for l, w in enumerate(cfg.window_schedule(capacity)):
        key = None if w >= capacity else int(w)
        groups.setdefault(key, []).append(l)
    keys = sorted(groups, key=lambda k: (k is not None, k or 0))
    return [(k, tuple(groups[k])) for k in keys]


def layer_group_index(cfg: ModelConfig, capacity: int) -> np.ndarray:
    """[L] int32: each layer's index into `layer_attn_groups`."""
    cls = np.zeros((cfg.n_layers,), np.int32)
    for gid, (_, layers) in enumerate(layer_attn_groups(cfg, capacity)):
        cls[list(layers)] = gid
    return cls


def init_paged_pool(
    cfg: ModelConfig, n_blocks: int, block_size: int, kv_dtype: str = "bf16",
    device="cuda",
) -> Tuple[torch.Tensor, ...]:
    """Stacked per-layer KV page pools [L, n_blocks, bs, KV, hd].
    `kv_dtype="bf16"` keeps the model's compute dtype and returns
    `(k_pages, v_pages)`; `"int8"` returns int8 codes plus f32 scale
    stacks [L, n_blocks, KV] initialised to 1.0:
    `(k_pages, v_pages, k_scales, v_scales)`."""
    if cfg.block_kind != "attn":
        raise ValueError(
            f"paged KV cache requires attention layers, got {cfg.block_kind}"
        )
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.hd)
    if kv_dtype == "bf16":
        dt = compute_dtype(cfg.dtype)
        return (torch.zeros(shape, dtype=dt, device=dev),
                torch.zeros(shape, dtype=dt, device=dev))
    if kv_dtype != "int8":
        raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got {kv_dtype!r}")
    sshape = (cfg.n_layers, n_blocks, cfg.n_kv_heads)
    return (
        torch.zeros(shape, dtype=torch.int8, device=dev),
        torch.zeros(shape, dtype=torch.int8, device=dev),
        torch.ones(sshape, dtype=torch.float32, device=dev),
        torch.ones(sshape, dtype=torch.float32, device=dev),
    )


def paged_plan_views(cfg, bucket_plan, bucket_perm, capacity):
    """Normalize `bucket_plan`, a single plan or a per-group tuple:
    (plans tuple|None, perms tuple|None, cls [L] host ints, each layer's
    plan index)."""
    if bucket_plan is None:
        plans, perms = None, None
    elif is_bucket_plan(bucket_plan):
        plans, perms = (bucket_plan,), (bucket_perm,)
    else:
        plans, perms = tuple(bucket_plan), tuple(bucket_perm)
    if plans is not None and len(plans) > 1:
        cls = layer_group_index(cfg, capacity).tolist()
    else:
        cls = [0] * cfg.n_layers
    return plans, perms, cls


def _per_layer_paged_views(cfg, block_table, block_start, bucket_plan,
                           bucket_perm, capacity):
    """Normalize the layer-major arguments: tables [B, mb] broadcast to
    every layer (or [L, B, mb] per layer), starts [B] / [L, B] / None,
    and the plans (`paged_plan_views`). Returns (bt [L,B,mb], starts
    [L,B], plans tuple|None, perms tuple|None, cls [L] host ints)."""
    l = cfg.n_layers
    if block_table.dim() == 2:
        block_table = block_table[None].expand((l,) + tuple(block_table.shape))
    b = block_table.shape[1]
    if block_start is None:
        block_start = torch.zeros((l, b), dtype=torch.int32,
                                  device=block_table.device)
    elif block_start.dim() == 1:
        block_start = block_start[None].expand(l, b)
    plans, perms, cls = paged_plan_views(cfg, bucket_plan, bucket_perm,
                                         capacity)
    return block_table, block_start, plans, perms, cls


def _run_layers(params, x, cfg, attn_fn, attn_args, k_pages, v_pages,
                block_table, block_start, bucket_plan, bucket_perm,
                k_scales, v_scales, impl):
    """The paged layer loop shared by decode and prefill: attention
    through `attn_fn` with each layer's pools, table, window and plan
    variant. `impl` reaches the attention kernels and every
    projection."""
    capacity = block_table.shape[-1] * k_pages.shape[2]
    bt, st, plans, perms, cls = _per_layer_paged_views(
        cfg, block_table, block_start, bucket_plan, bucket_perm, capacity
    )
    if tensor_parallel() is not None:
        raise TensorParallelUnsupported(
            "paged serving runs on one rank, as the reference's does; run "
            "it without a model axis")
    quantized = k_scales is not None

    def attn(l, p, h, window):
        return attn_fn(
            p, h, *attn_args, k_pages[l], v_pages[l], bt[l].contiguous(),
            window=window, impl=impl, block_start=st[l].contiguous(),
            bucket_plans=plans, bucket_perms=perms, plan_class=cls[l],
            k_scales=k_scales[l] if quantized else None,
            v_scales=v_scales[l] if quantized else None,
            **_attn_kwargs(cfg, l),
        )[0]

    return _layer_loop(params, x, cfg, _window_array(cfg, capacity), attn,
                       impl)[0]


def decode_step_paged(
    params: Params,
    token: torch.Tensor,        # [B, 1] int — one token per slot
    k_pages: torch.Tensor,      # [L, n_blocks, bs, KV, hd]
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # [L, B, max_blocks] or [B, max_blocks] int32
    positions: torch.Tensor,    # [B] int32 — per-slot index of the new token
    cfg: ModelConfig,
    impl: str = "auto",
    bucket_plan=None,
    bucket_perm=None,
    block_start=None,           # [L, B] / [B] / None first live block
    k_scales=None,              # [L, n_blocks, KV] f32 (int8 pools only)
    v_scales=None,
) -> Tuple[torch.Tensor, ...]:
    """One decode step against the paged cache, per-slot positions.
    Pools (and scales) are updated in place and returned:
    `(logits [B, 1, V], k_pages, v_pages[, k_scales, v_scales])`."""
    _require_attention(cfg, "decode_step_paged")
    x = _embed(params, token, cfg)
    x = _run_layers(params, x, cfg, attention_decode_paged, (positions,),
                    k_pages, v_pages, block_table, block_start, bucket_plan,
                    bucket_perm, k_scales, v_scales, impl)
    logits = _head(params, x, cfg)
    if k_scales is not None:
        return logits, k_pages, v_pages, k_scales, v_scales
    return logits, k_pages, v_pages


def prefill_paged(
    params: Params,
    tokens: torch.Tensor,       # [B, T] int — uncached suffix (T padded)
    k_pages: torch.Tensor,      # [L, n_blocks, bs, KV, hd]
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # [L, B, max_blocks] or [B, max_blocks] int32
    start: torch.Tensor,        # [B] int32 — cached-prefix length per slot
    total: torch.Tensor,        # [B] int32 — full valid length per slot
    cfg: ModelConfig,
    last_pos: Optional[int] = None,
    impl: str = "auto",
    bucket_plan=None,
    bucket_perm=None,
    block_start=None,
    k_scales=None,
    v_scales=None,
) -> Tuple[torch.Tensor, ...]:
    """Prefill the uncached suffix straight into the paged pools (in
    place); each layer's attention covers the cached prefix pages through
    K2's offset causal mask. `last_pos` (suffix-relative) selects which
    position's logits to return instead of T-1. Returns
    `(logits [B, 1, V], k_pages, v_pages[, k_scales, v_scales])`."""
    _require_attention(cfg, "prefill_paged")
    x = _embed(params, tokens, cfg)
    x = _run_layers(params, x, cfg, attention_prefill_paged, (start, total),
                    k_pages, v_pages, block_table, block_start, bucket_plan,
                    bucket_perm, k_scales, v_scales, impl)
    t_last = x.shape[1] - 1 if last_pos is None else int(last_pos)
    logits = _head(params, x[:, t_last: t_last + 1], cfg)
    if k_scales is not None:
        return logits, k_pages, v_pages, k_scales, v_scales
    return logits, k_pages, v_pages
