"""Allocation-free stand-ins and layouts for every cell: counterpart of
`repro.launch.specs`.

Parameters, optimizer state, caches and batches are built on the
`meta` device, so nothing is allocated; layouts are specs (tuples, as
`dist.sharding` resolves them) derived from the sharding rules, with
divisibility-aware fallbacks (a mesh axis is used only when it divides
the dimension). The reference returns `NamedSharding`s; a port spec
goes with the mesh it was made for. `dist.sharding.place_tree` cuts a
whole tree to a rank's blocks by these specs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..dist.sharding import (
    STATE_DIMS,
    Spec,
    current_context,
    params_partition_specs,
    sharding_rules,
    state_model_dim,
    suspended,
)
from ..models import init_cache, init_encdec, init_encdec_cache, init_lm
from ..optim import AdamWState, adamw_init
from ..quant.bitplane import PimQuantConfig, PimWeight, quantize_tree

META = torch.device("meta")


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    names = (name,) if isinstance(name, str) else tuple(name)
    out = 1
    for n in names:
        if n in mesh.axis_names:
            out *= mesh.shape[n]
    return out


def _fit(mesh, dim: int, axes) -> Optional[Any]:
    """Use `axes` for this dim only if it divides evenly."""
    if axes is None:
        return None
    size = _axis_size(mesh, axes)
    if size > 1 and dim % size == 0:
        return axes
    # try single-axis fallback for composite specs
    if not isinstance(axes, str):
        for a in axes:
            if _axis_size(mesh, a) > 1 and dim % _axis_size(mesh, a) == 0:
                return a
    return None


def _spec(*axes) -> Spec:
    """A spec from its entries: a one-axis tuple as its name (as a
    `PartitionSpec` normalises it), trailing Nones dropped."""
    out = [a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in axes]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_rows(mesh, b: int) -> Optional[Any]:
    """The spec entry the rows of a global batch of `b` are split over:
    the batch axes where `b` divides over them, else the first of them
    that divides it, else None. Every batch spec below splits rows so; a
    caller that does gives the same entry to `sharding_rules(rows=)`."""
    return _fit(mesh, b, batch_axes(mesh))


# ---------------------------------------------------------------------------
# parameter / optimizer specs
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig, quantized: bool = False):
    """The parameter tree on the `meta` device (f32 masters, as the
    reference's); with quantized=True the projection weights are
    PIM-packed `PimWeight`s — still allocation-free (the quantize and
    pack run on meta tensors)."""
    gen = torch.Generator()
    if cfg.is_encoder_decoder:
        params = init_encdec(cfg, gen, META, param_dtype=torch.float32)
    else:
        params = init_lm(cfg, gen, META, param_dtype=torch.float32)
    if not quantized:
        return params
    qcfg = PimQuantConfig(n_bits=cfg.quant_bits, group=cfg.quant_group,
                          impl="ref", min_features=1024)
    return quantize_tree(params, qcfg)


def abstract_opt_state(params_shapes) -> AdamWState:
    return adamw_init(params_shapes)


def param_shardings(params_shapes, mesh, rules=None):
    """The spec tree of `params_partition_specs` with each entry kept only
    where it divides its dimension."""
    with sharding_rules(mesh, rules):
        specs = params_partition_specs(params_shapes)

    def fixup(spec, leaf):
        if isinstance(spec, dict):
            return {k: fixup(spec[k], leaf[k]) for k in spec}
        if isinstance(spec, PimWeight):
            return PimWeight(fixup(spec.planes, leaf.planes),
                             fixup(spec.scale, leaf.scale),
                             spec.n_bits, spec.group)
        shape = leaf.shape
        return _spec(*(_fit(mesh, shape[i], ax) if i < len(shape) else None
                       for i, ax in enumerate(spec)))

    return fixup(specs, params_shapes)


def opt_shardings(opt_shapes: AdamWState, p_shard) -> AdamWState:
    return AdamWState(step=(), m=p_shard, v=p_shard)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    b, t = shape.global_batch, shape.seq_len
    bspec = batch_rows(mesh, b)
    tok = _meta((b, t), torch.int32)
    batch = {"tokens": tok, "targets": tok}
    shards = {"tokens": _spec(bspec), "targets": _spec(bspec)}
    if cfg.is_encoder_decoder:
        batch["frames"] = _meta((b, t, cfg.d_model), torch.float32)
        shards["frames"] = _spec(bspec, None,
                                 _fit(mesh, cfg.d_model, "model"))
    elif cfg.frontend == "vision_stub":
        nf = cfg.frontend_tokens
        batch["tokens"] = _meta((b, t - nf), torch.int32)
        batch["targets"] = _meta((b, t - nf), torch.int32)
        batch["patches"] = _meta((b, nf, cfg.d_model), torch.float32)
        shards["patches"] = _spec(bspec, None,
                                  _fit(mesh, cfg.d_model, "model"))
    return batch, shards


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """The whole decode cache on the `meta` device (built outside any
    sharding context, which would cut it to a rank's blocks)."""
    b, s = shape.global_batch, shape.seq_len
    with suspended():
        if cfg.is_encoder_decoder:
            return init_encdec_cache(cfg, b, s, s, device=META)
        return init_cache(cfg, b, s, device=META)


def cache_shardings(cache_shapes, cfg: ModelConfig, shape: ShapeConfig,
                    mesh) -> Dict[str, Spec]:
    """Rule-based cache layout:

    decode_32k (large batch): batch over (pod,data), kv-heads over model.
    long_500k  (batch=1):     sequence over data (SP), heads/inner over model.
    """
    b = shape.global_batch
    bspec = batch_rows(mesh, b)
    ctx = current_context()

    def spec_for(key: str, leaf) -> Spec:
        shp = tuple(getattr(leaf, "shape", ()))
        if key == "position" or len(shp) == 0:
            return ()
        if key in ("k", "v", "shared_k", "shared_v", "xk", "xv"):
            # [L, B, S, KV, hd] — resolved through the SAME rule context
            # the model's shard_cache hook uses, so the two never disagree
            if ctx is None:
                raise RuntimeError("cache_shardings needs sharding_rules()")
            return ctx.resolve("layers", "batch", "kv_seq", "kv_heads",
                               "cache_head_dim", shape=shp)
        if key in STATE_DIMS:
            # the recurrent states, [L, B, ...]: the dimension the model
            # code reads and writes its block of (`state_model_dim`)
            d = state_model_dim(key, shp, _axis_size(mesh, "model"))
            return _spec(None, bspec, *("model" if i == d else None
                                        for i in range(2, len(shp))))
        return ()

    return {k: spec_for(k, v) for k, v in cache_shapes.items()}


def decode_token_spec(shape: ShapeConfig, mesh):
    b = shape.global_batch
    bspec = batch_rows(mesh, b)
    return _meta((b, 1), torch.int32), _spec(bspec)


def prefill_token_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    b, t = shape.global_batch, shape.seq_len
    bspec = batch_rows(mesh, b)
    return _meta((b, t), torch.int32), _spec(bspec)
