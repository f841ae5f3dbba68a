"""Roofline terms of one step: counterpart of `repro.launch.roofline`.

compute    = counted FLOPs / peak          (per device)
memory     = bytes / HBM bandwidth          (analytic model, see below)
collective = collective bytes / link rate   (counted by `dist.collectives`)

at the port's card, `core.tpu_gold.H100_SXM`.

What is ported as is. The closed forms — `DTYPE_BYTES`,
`count_tree_bytes`, `analytic_bytes_for_cell`, `count_tree_params`,
`active_matmul_params`, `_attention_spans`, `_cell_flops_per_token` and
`model_flops_for_cell` — are the reference's, over the port's abstract
trees (`launch.specs.abstract_params`: meta tensors, a `PimWeight`'s
planes counted at their packed uint8 size).

What has no line-by-line counterpart. The reference parses XLA's
optimized HLO text (`HloAnalysis`, `collective_bytes_from_hlo`) and
reads `compiled.cost_analysis()` / `memory_analysis()` in
`analyze_compiled`: it must, because a compiled program is all it has,
and XLA's cost analysis visits a loop body once, so the parse multiplies
dot FLOPs and collective bytes through the loop nest. The port runs
eagerly, so it counts the step by running it once (`count_step`):

  * FLOPs: every aten op the step dispatches is priced by
    `torch.utils.flop_counter`'s registry (what `FlopCounterMode`
    uses) under a `TorchDispatchMode`. Eager execution visits every
    layer, so there is no loop-trip correction to make.
  * Kernel work: K1-K4 launch through `ctypes`, which no dispatch mode
    sees, so each kernel's dispatch point reports its own FLOPs and
    bytes from the shapes (`kernels.work`), on both routes; the aten
    ops a plain route runs inside that report are not counted again.
    The count is the same whatever implements the kernel.
  * Collective bytes: the difference of `dist.collectives.read_counts()`
    over the step, per kind (`collectives_by_kind`).

Memory is the analytic model, as in the reference (its HBM bytes cannot
be read off a program either), plus, for a measured step
(`kernel_bytes=True`), the bytes the kernels report: the caller then
passes the analytic bytes of what no kernel reads
(`unkerneled_param_bytes`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..core.tpu_gold import H100_SXM, ChipSpec, RooflineTerms, roofline_terms
from ..dist import collectives
from ..kernels import work
from ..quant.bitplane import PimWeight

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}


# ---------------------------------------------------------------------------
# counting one step
# ---------------------------------------------------------------------------

class FlopCount(TorchDispatchMode):
    """FLOPs of the aten ops dispatched inside, by op, priced by
    `torch.utils.flop_counter`'s registry; ops inside an open kernel
    dispatch (`kernels.work.inside()`) are the kernel's, and skipped."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.by_op: Dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None and not work.inside():
            f = float(formula(*args, **kwargs, out_val=out))
            self.flops += f
            name = str(func._overloadpacket)
            self.by_op[name] = self.by_op.get(name, 0.0) + f
        return out


def _collective_bytes(before, after) -> Dict[str, float]:
    return {k: float(after[k]["bytes"] - before.get(k, {}).get("bytes", 0))
            for k in after
            if k != "staged" and after[k]["bytes"] != before.get(
                k, {}).get("bytes", 0)}


def count_step(step: Callable[[], object]) -> Tuple[object, Dict]:
    """Run `step()` once under the FLOP counter, a kernel work meter and
    the collective counts. Returns its output and the count: `aten_flops`,
    `kernel_flops`, `flops` (their sum), `kernel_bytes`, `kernels` (per
    kernel: calls, flops, bytes), `flops_by_op` and
    `collectives_by_kind` (bytes this rank moved, per kind)."""
    before = collectives.read_counts()
    with work.WorkMeter() as meter, FlopCount() as fc:
        out = step()
    by_kind = _collective_bytes(before, collectives.read_counts())
    return out, {
        "aten_flops": fc.flops,
        "kernel_flops": meter.flops,
        "flops": fc.flops + meter.flops,
        "kernel_bytes": meter.bytes,
        "kernels": meter.by_kernel(),
        "flops_by_op": dict(sorted(fc.by_op.items())),
        "collectives_by_kind": by_kind,
        "collective_bytes": sum(by_kind.values()),
    }


def analyze_step(
    cell: str,
    step: Callable[[], object],
    chips: int,
    model_flops: float,
    analytic_bytes: float = 0.0,
    chip: ChipSpec = H100_SXM,
    kernel_bytes: bool = False,
) -> Tuple[RooflineTerms, Dict]:
    """The roofline terms of one run of `step()` on this rank, and the
    detail: the reference's `analyze_compiled` for an eager step.
    `analytic_bytes` is global (divided by `chips`), as there; with
    `kernel_bytes` the kernels' reported bytes are added (a measured
    step, whose analytic part leaves out what the kernels read)."""
    _, count = count_step(step)
    return terms_from_count(cell, count, chips, model_flops, analytic_bytes,
                            chip, kernel_bytes)


def terms_from_count(
    cell: str,
    count: Dict,
    chips: int,
    model_flops: float,
    analytic_bytes: float = 0.0,
    chip: ChipSpec = H100_SXM,
    kernel_bytes: bool = False,
    memory_analysis: Optional[Dict[str, Optional[int]]] = None,
    bytes_per_device: float = 0.0,
) -> Tuple[RooflineTerms, Dict]:
    """`analyze_step`'s terms and detail from a `count_step` count;
    `memory_analysis` (the dry run's per-rank argument and temp bytes)
    is carried into the detail. The detail keeps the reference's keys
    where they mean the same (`collectives_by_kind`, `memory_analysis`,
    `analytic_bytes_per_device`); `counted_flops` and `kernel_work`
    stand where it has `loop_corrected_flops` and `raw_cost_analysis`."""
    bytes_accessed = analytic_bytes / max(chips, 1)
    if kernel_bytes:
        bytes_accessed += count["kernel_bytes"]
    terms = roofline_terms(
        cell=cell, chips=chips, hlo_flops=count["flops"],
        hlo_bytes=bytes_accessed,
        collective_bytes=count["collective_bytes"],
        model_flops=model_flops, chip=chip,
        bytes_per_device=bytes_per_device,
    )
    detail = {
        "collectives_by_kind": count["collectives_by_kind"],
        "memory_analysis": dict(memory_analysis or {}),
        "counted_flops": {"aten": count["aten_flops"],
                          "kernels": count["kernel_flops"]},
        "kernel_work": count["kernels"],
        "kernel_bytes": count["kernel_bytes"],
        "flops_by_op": count["flops_by_op"],
        "analytic_bytes_per_device": analytic_bytes / max(chips, 1),
    }
    return terms, detail


def unkerneled_param_bytes(params) -> int:
    """Bytes of the parameter leaves no kernel reports: everything but
    the `PimWeight`s, whose planes and scales K3/K4 read and report."""
    if isinstance(params, dict):
        return sum(unkerneled_param_bytes(v) for v in params.values())
    if isinstance(params, PimWeight):
        return 0
    return _leaf_bytes(params)


# ---------------------------------------------------------------------------
# analytic HBM byte model (per step, GLOBAL — divide by chips for per-device)
# ---------------------------------------------------------------------------

def _named_leaves(tree, prefix: str = ""):
    """(path, tensor) for every tensor leaf; a `PimWeight` gives its
    planes and scale under its own path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, PimWeight):
        yield from _named_leaves({"planes": tree.planes, "scale": tree.scale},
                                 prefix)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def _leaf_bytes(leaf) -> int:
    return leaf.numel() * leaf.element_size() if isinstance(
        leaf, torch.Tensor) else 0


def count_tree_bytes(shapes) -> int:
    """Actual parameter bytes from leaf dtypes — PIM-packed uint8 planes
    count at their packed size (the paper's bandwidth amplification shows
    up here automatically)."""
    return sum(_leaf_bytes(leaf) for _, leaf in _named_leaves(shapes))


def analytic_bytes_for_cell(cfg, shape, params_shapes) -> float:
    """First-principles HBM traffic for one step (documented napkin math).

    Weights are f32 in the abstract trees (4 B/param); a bf16-resident
    production variant halves the P terms, and the PIM bit-plane variant
    reduces projection bytes to n_bits/32 of it — reflected automatically
    via count_tree_bytes on the (possibly packed) parameter tree.
    """
    p_total = count_tree_params(params_shapes)
    p_bytes = count_tree_bytes(params_shapes)
    b, s = shape.global_batch, shape.seq_len
    d, l = cfg.d_model, cfg.n_layers
    act_el = 2  # bf16 activations
    if shape.kind == "train":
        # params read + grad write/read + adam m,v read+write + param write
        opt = p_bytes + p_total * 4 * (2 + 4 + 1)
        # remat: save 1 residual per layer, read it back, recompute fwd
        acts = 3 * b * s * d * l * act_el * 2
        return float(opt + acts)
    if shape.kind == "prefill":
        kv = 2 * l * b * s * cfg.n_kv_heads * cfg.hd * act_el  # cache write
        acts = 4 * b * s * d * l * act_el
        return float(p_bytes + kv + acts)
    # decode: every resident weight byte streams once (the paper's bound),
    # plus the KV/state sweep
    kv_read = 0.0
    if cfg.block_kind == "attn" or cfg.attn_every > 0:
        n_attn = l if cfg.block_kind == "attn" else sum(
            1 for f in cfg.layer_flags()["has_shared_attn"] if f
        )
        spans = (
            [min(w, s) for w in cfg.window_schedule(s)]
            if cfg.block_kind == "attn" else [s] * n_attn
        )
        kv_read = sum(2 * b * sp * cfg.n_kv_heads * cfg.hd * act_el for sp in spans)
    state = 0.0
    if cfg.block_kind == "mamba":
        pdim = cfg.d_inner // max(cfg.ssm_heads, 1)
        state = 2 * l * b * cfg.ssm_heads * pdim * cfg.ssm_state * 4
    if cfg.block_kind == "xlstm":
        hd = cfg.ssm_expand * d // cfg.n_heads
        state = 2 * l * b * cfg.n_heads * hd * hd * 4
    return float(p_bytes + kv_read + state)


# ---------------------------------------------------------------------------
# MODEL_FLOPS accounting (6ND / 2ND + attention sweep)
# ---------------------------------------------------------------------------

def count_tree_params(shapes, predicate=None) -> int:
    return sum(leaf.numel() for name, leaf in _named_leaves(shapes)
               if predicate is None or predicate(name))


def active_matmul_params(cfg, params_shapes) -> float:
    """Parameters touched per token: excludes the embedding gather and the
    non-routed fraction of expert weights (MoE: top_k of n_experts)."""
    total = count_tree_params(params_shapes)
    embed = count_tree_params(params_shapes, lambda n: n.endswith("embed"))
    expert = count_tree_params(params_shapes, lambda n: "/we_" in n or n.startswith("we_"))
    active = total - embed - expert
    if cfg.n_experts:
        active += expert * (cfg.top_k / cfg.n_experts)
    # tied embeddings: the lm_head matmul reuses the embed table -> count it
    if "lm_head" not in params_shapes:
        active += embed
    return float(active)


def _attention_spans(cfg, s: int):
    """Per-attention-layer causal score spans (avg attended positions)."""
    if cfg.is_encoder_decoder:
        # enc bidirectional (span s) + dec self (causal s/2) + dec cross (s)
        return ([("full", s)] * cfg.n_encoder_layers
                + [("causal", s)] * cfg.n_layers
                + [("full", s)] * cfg.n_layers)
    if cfg.block_kind == "attn":
        return [("causal", min(w, s)) for w in cfg.window_schedule(s)]
    if cfg.attn_every > 0:  # zamba2 shared-attn sites
        n_sites = sum(1 for f in cfg.layer_flags()["has_shared_attn"] if f)
        return [("causal", s)] * n_sites
    return []


def _cell_flops_per_token(cfg, s: int) -> float:
    """Recurrent-cell state flops per token per layer (non-dot compute)."""
    if cfg.block_kind == "mamba":
        p = cfg.d_inner // max(cfg.ssm_heads, 1)
        return 6.0 * cfg.ssm_heads * p * cfg.ssm_state * cfg.n_layers
    if cfg.block_kind == "xlstm":
        hdx = cfg.ssm_expand * cfg.d_model // cfg.n_heads
        return 6.0 * cfg.n_heads * hdx * hdx * cfg.n_layers
    return 0.0


def model_flops_for_cell(cfg, shape, params_shapes) -> float:
    """Algorithmically-necessary FLOPs for one step of this cell."""
    n = active_matmul_params(cfg, params_shapes)
    b, s = shape.global_batch, shape.seq_len
    hd = cfg.hd
    spans = _attention_spans(cfg, s)
    if shape.kind in ("train", "prefill"):
        mult = 3.0 if shape.kind == "train" else 1.0  # fwd(+bwd 2x)
        flops = mult * 2.0 * n * (b * s)
        for kind, span in spans:
            eff = span / 2 if kind == "causal" else span
            flops += mult * 4.0 * b * s * eff * cfg.n_heads * hd
        flops += mult * b * s * _cell_flops_per_token(cfg, s)
        return flops
    # decode: one token per sequence + full KV/state sweep
    flops = 2.0 * n * b
    for kind, span in spans:
        flops += 4.0 * b * span * cfg.n_heads * hd
    flops += b * _cell_flops_per_token(cfg, s)
    return flops


def shares(terms: RooflineTerms, measured_s: float) -> Dict[str, float]:
    """The terms beside a measured step time: `bound_s / measured_s` is
    at most 1 when the counts are right (a step cannot beat its bound)."""
    return {"compute_s": terms.compute_s, "memory_s": terms.memory_s,
            "collective_s": terms.collective_s, "bound": terms.bound,
            "bound_s": terms.bound_s,
            "roofline_fraction": terms.roofline_fraction,
            "measured_s": measured_s,
            "bound_share": (terms.bound_s / measured_s if measured_s > 0
                            else math.nan)}
