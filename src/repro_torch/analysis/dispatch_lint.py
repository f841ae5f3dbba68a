"""Lint of the serve steps as they run: counterpart of
`repro.analysis.jaxpr_lint` (DESIGN.md §15).

The reference traces its jitted steps and walks the jaxpr. The port runs
eagerly, so it walks the aten ops a step dispatches, under a
`TorchDispatchMode`, while running the real steps of `serve/compiled.py`
(`paged_prefill_step`, `paged_decode_step`; bf16 and int8 pools, dense
and bit-plane weights) exactly as `ContinuousBatcher` calls them. Rules
(the reference's ids):

  JX001  host round-trips inside a step: `aten._local_scalar_dense`
         (`.item()`, `int(t)`, `.tolist()`), `nonzero`, `is_nonzero`
         (`bool(t)`), `equal`, and copies of a device tensor to the CPU.
         On the card the step also runs under
         `torch.cuda.set_sync_debug_mode("error")`, and a sync it raises
         is a finding too.
  JX002  a float64 / complex128 value anywhere in the step.
  JX003  whole-pool materialization outside the kernels: an op whose
         output is a new buffer (it shares no storage with any input, so
         views and in-place page writes are exempt) of at least the whole
         pool's elements, or one that reads a KV pool and copies at least
         one layer's pool (a `.contiguous()` of a pool before a launch).
         Sizes are counted in elements, so a dequantized (f32) copy of an
         int8 pool is pool-sized and a f32 temporary four times an int8
         pool's bytes is not.
         Ops inside an open kernel dispatch (`kernels.work`: the CUDA
         launch path or the plain version standing for it) are the
         kernel's and exempt, as the reference exempts ops inside a
         `pallas_call` body.
  JX004  the layer-group dispatch: the bucket plans a step selects per
         layer (`models.attention._select_bucket_plan`, recorded while
         the step runs) must number `len(layer_attn_groups(cfg,
         capacity))`, in the plan tuple and in the distinct plans picked.
  JX005  an integer step input that is not the step's declared dtype
         (`serve.compiled.STEP_INT_DTYPE`; bucket permutations
         `PERM_DTYPE`), e.g. a default int64 `torch.tensor(list)`: it
         splits `ServeStep`'s signature set as a weak type splits the
         reference's jit key.

`lint_call` lints any callable (the fixture tests use tiny ones);
`lint_serve_steps` runs the real steps on `probe_config()`, the
reference's two-group probe: on the CPU with the plain versions, on the
card with K1-K4.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..kernels import work
from .findings import Finding

_HOST_OPS = frozenset({"aten._local_scalar_dense", "aten.nonzero",
                       "aten.is_nonzero", "aten.equal"})
_WIDE_DTYPES = (torch.float64, torch.complex128)


def _storage(t: torch.Tensor) -> Optional[int]:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return None


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


class _Walk(TorchDispatchMode):
    """Records JX001-JX003 findings for the ops dispatched inside."""

    def __init__(self, where: str, pools: Sequence[torch.Tensor],
                 layer_pool_numel: Optional[int]):
        super().__init__()
        self.where = where
        self.pool_numel = max((p.numel() for p in pools), default=None)
        self.layer_pool_numel = layer_pool_numel
        self.pools = {s for s in map(_storage, pools) if s}
        self.findings: List[Finding] = []

    def add(self, rule: str, msg: str, severity: str = "error") -> None:
        f = Finding(rule, self.where, 0, severity, msg)
        if f not in self.findings:
            self.findings.append(f)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func._overloadpacket)
        ins = _tensors((args, kwargs))
        if name in _HOST_OPS:
            self.add("JX001", f"host round-trip `{name}` in the hot path — "
                     "one device-to-host sync per serve step")
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if name == "aten._to_copy" and any(
                t.device.type != "cpu" for t in ins) and any(
                o.device.type == "cpu" for o in outs):
            self.add("JX001", f"`{name}` copies a device tensor to the CPU "
                     "inside the step — one host round-trip per serve step")
        for o in outs:
            if o.dtype in _WIDE_DTYPES:
                self.add("JX002", f"`{name}` produces {o.dtype} — float64 "
                         "creep in the step")
        if self.pool_numel and not work.inside():
            self._pool_copies(name, ins, outs)
        return out

    def _pool_copies(self, name, ins, outs) -> None:
        in_storage = {s for s in map(_storage, ins) if s}
        reads_pool = bool(in_storage & self.pools)
        for o in outs:
            s = _storage(o)
            if s is None or s in in_storage:
                continue            # a view, or written in place
            n = o.numel()
            if n >= self.pool_numel:
                self.add("JX003", f"`{name}` materializes a pool-sized "
                         f"buffer ({n} elements) outside any kernel — a "
                         "whole-pool copy per step")
            elif (reads_pool and self.layer_pool_numel
                  and n >= self.layer_pool_numel):
                self.add("JX003", f"`{name}` copies {n} elements of a KV "
                         "pool outside any kernel — a layer-pool copy per "
                         "step")


@contextlib.contextmanager
def _recorded_plans(record: list):
    """Record `(n_plans, selected index)` for every per-layer plan
    selection made inside (`models.attention._select_bucket_plan`)."""
    from ..models import attention

    orig = attention._select_bucket_plan

    def select(call, bucket_plans, bucket_perms, plan_class):
        if bucket_plans is not None:
            idx = (0 if plan_class is None or len(bucket_plans) == 1
                   else int(plan_class))
            record.append((len(bucket_plans), idx))
        return orig(call, bucket_plans, bucket_perms, plan_class)

    attention._select_bucket_plan = select
    try:
        yield
    finally:
        attention._select_bucket_plan = orig


@contextlib.contextmanager
def _sync_errors(on_card: bool):
    if not on_card:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def lint_call(
    fn: Callable[[], object],
    where: str,
    *,
    pools: Sequence[torch.Tensor] = (),
    n_layers: int = 1,
    expected_groups: Optional[int] = None,
    int_inputs: Iterable[torch.Tensor] = (),
    perm_inputs: Iterable[torch.Tensor] = (),
    inputs: Iterable[torch.Tensor] = (),
) -> List[Finding]:
    """Run `fn()` once and apply JX001-JX005 to what it dispatched.

    `pools`: the KV pools ([L, ...] stacks, `n_layers` deep) whose copies
    JX003 looks for; `expected_groups`: the layer-group count JX004 holds
    the selected plans to; `int_inputs` / `perm_inputs`: the step's
    integer inputs and bucket permutations (JX005); `inputs`: every
    tensor input (JX002)."""
    from ..serve.compiled import PERM_DTYPE, STEP_INT_DTYPE

    pools = list(pools)
    layer = (max(p.numel() for p in pools) // max(n_layers, 1)
             if pools else None)
    walk = _Walk(where, pools, layer)
    for i, t in enumerate(int_inputs):
        if t.dtype != STEP_INT_DTYPE:
            walk.add("JX005", f"integer step input {i} is {t.dtype}, not "
                     f"{STEP_INT_DTYPE} — it splits the step's signature "
                     "set (§11 bounded recompile set)", "warning")
    for i, t in enumerate(perm_inputs):
        if t is not None and t.dtype != PERM_DTYPE:
            walk.add("JX005", f"bucket permutation {i} is {t.dtype}, not "
                     f"{PERM_DTYPE} — it splits the step's signature set",
                     "warning")
    for i, t in enumerate(inputs):
        if t.dtype in _WIDE_DTYPES:
            walk.add("JX002", f"step input {i} is {t.dtype} — 64-bit values "
                     "in the serve step double page bytes")
    on_card = any(t.is_cuda for t in list(pools) + list(inputs))
    plans: list = []
    try:
        with _recorded_plans(plans), work.KernelScopes(), walk, \
                _sync_errors(on_card):
            fn()
    except RuntimeError as e:
        if not on_card or "synchroniz" not in str(e):
            raise
        walk.add("JX001", f"the step synchronises with the host under "
                 f"set_sync_debug_mode('error'): {str(e).splitlines()[0]}")
    if expected_groups is not None and plans:
        sizes = {n for n, _ in plans}
        picked = {i for _, i in plans}
        if sizes != {expected_groups} or len(picked) != expected_groups:
            walk.add("JX004", f"the step's layers select from "
                     f"{sorted(sizes)} plan(s) and pick {len(picked)} "
                     f"distinct one(s), but layer_attn_groups gives "
                     f"{expected_groups} groups — plan tuple and group "
                     "partition disagree")
    return walk.findings


# ---------------------------------------------------------------------------
# the serve-step probe
# ---------------------------------------------------------------------------

def probe_config():
    """Smallest config with TWO layer groups (layer 0 sliding-window(4),
    layer 1 global) — exercises the per-group plan tuple, the group
    dispatch, and window-aware bucketing in one run."""
    from ..configs.base import ModelConfig

    return ModelConfig(
        name="analysis-probe", family="dense", n_layers=2, d_model=8,
        n_heads=2, n_kv_heads=1, d_ff=16, vocab_size=32, dtype="float32",
        local_global_ratio=1, sliding_window=4,
    )


def _plans(pc, eff_lengths, slots, device):
    """The per-group plans and permutations the card's batcher builds
    (`ops.plan_buckets_grouped`, the planner half of
    `bucket_args_grouped`), on any device, so the plain route's walk
    selects them too."""
    from ..kernels.ops import plan_buckets_grouped

    plans, perms = plan_buckets_grouped(
        pc.bucket_needs(eff_lengths, slots=slots), pc.max_blocks_per_slot)
    if plans is None:
        return None, None
    return plans, tuple(
        None if p is None else torch.tensor(p, dtype=torch.int64,
                                            device=device)
        for p in perms)


def probe_steps(cfg, params, device, impl: str = "auto",
                kv_dtype: str = "bf16", n_slots: int = 2,
                lengths: Sequence[int] = (9, 3), prompt: int = 9,
                cached: int = 0, block_size: int = 4, max_len: int = 16):
    """`(name, fn, lint_kwargs)` for one decode and one prefill of the
    real `serve/compiled.py` steps over a fresh `PagedKVCache`, called
    as `ContinuousBatcher` calls them: decode over `lengths` (ragged, so
    the plans hold more than one bucket), prefill of `prompt` tokens of
    slot 0 after `cached` cached ones."""
    from ..models.transformer import layer_attn_groups
    from ..serve.compiled import (STEP_INT_DTYPE, paged_decode_step,
                                  paged_prefill_step)
    from ..serve.paged_cache import PagedKVCache

    pc = PagedKVCache(cfg, n_slots=n_slots, max_len=max_len,
                      block_size=block_size, kv_dtype=kv_dtype,
                      device=device)
    for slot, n in enumerate(lengths):
        pc.alloc_slot(slot, max(n, cached + prompt) if slot == 0 else n)
        pc.lengths[slot] = n
    capacity = pc.max_blocks_per_slot * pc.block_size
    pools = [pc.k_pages, pc.v_pages]
    common = dict(pools=pools, n_layers=cfg.n_layers,
                  expected_groups=len(layer_attn_groups(cfg, capacity)))
    scales = (pc.k_scales, pc.v_scales) if pc.quantized else ()
    out = []

    plans, perms = _plans(pc, np.asarray(pc.lengths) + 1, None, device)
    step = paged_decode_step(cfg, impl=impl, kv_dtype=kv_dtype)
    tok = torch.zeros((n_slots, 1), dtype=STEP_INT_DTYPE, device=device)
    bt, st = pc.device_block_tables(), pc.device_block_starts()
    pos = pc.device_positions()
    args = (params, tok, pc.k_pages, pc.v_pages, *scales, bt, st, pos)
    out.append(("decode", lambda: step(*args, perms=perms, plans=plans),
                dict(common, int_inputs=[tok, bt, st, pos],
                     perm_inputs=perms or (),
                     inputs=[tok, *pools, *scales, bt, st, pos])))

    total = cached + prompt
    pad = -(-prompt // block_size) * block_size
    p_plans, p_perms = _plans(pc, [total], [0], device)
    pstep = paged_prefill_step(cfg, impl=impl, kv_dtype=kv_dtype)
    toks = torch.zeros((1, pad), dtype=STEP_INT_DTYPE, device=device)
    pbt, pst = pc.device_block_tables(), pc.device_block_starts()
    if pbt.dim() == 2:
        pbt, pst = pbt[0:1], pst[0:1]
    else:
        pbt, pst = pbt[:, 0:1], pst[:, 0:1]
    start = torch.tensor([cached], dtype=STEP_INT_DTYPE, device=device)
    end = torch.tensor([total], dtype=STEP_INT_DTYPE, device=device)
    pargs = (params, toks, pc.k_pages, pc.v_pages, *scales, pbt, pst, start,
             end, prompt - 1)
    out.append(("prefill",
                lambda: pstep(*pargs, perms=p_perms, plans=p_plans),
                dict(common, int_inputs=[toks, pbt, pst, start, end],
                     perm_inputs=p_perms or (),
                     inputs=[toks, *pools, *scales, pbt, pst, start, end])))
    return out


def lint_serve_steps(cfg=None, device="cpu", impl: str = "auto",
                     seed: int = 0) -> List[Finding]:
    """Run the real decode and prefill steps on the probe config — bf16
    pools, int8 pools, and bit-plane (8-bit) weights — and lint each."""
    from ..models import init_lm
    from ..quant.bitplane import PimQuantConfig, quantize_tree

    cfg = cfg or probe_config()
    dev = torch.device(device)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    pim = quantize_tree(params, PimQuantConfig(n_bits=8, group=1, impl=impl,
                                               min_features=1))
    findings: List[Finding] = []
    with torch.no_grad():
        for variant, p, kv in (("bf16", params, "bf16"),
                               ("int8", params, "int8"),
                               ("pim8", pim, "bf16")):
            for name, fn, kw in probe_steps(cfg, p, dev, impl=impl,
                                            kv_dtype=kv):
                findings.extend(lint_call(
                    fn, f"<dispatch:{name}:{variant}>", **kw))
    return findings
