"""Step callables over the model's serving entry points: counterpart of
`repro.serve.compiled` (`jit_paged_prefill` / `jit_paged_decode` /
`jit_dense_prefill` / `jit_dense_decode`).

`ServeEngine` and `ContinuousBatcher` drive the same steps (suffix
prefill into the page pools and one-token paged decode; prefill into a
new dense cache and one-token dense decode); building them here keeps
the `models` call signatures in one place. PyTorch runs eagerly, so there is nothing to
compile: each step is a plain callable, and on the card's kernel path
the paged decode step serves its calls from piecewise CUDA graphs
captured once per signature (`serve.graphs`). What the reference's jit cache
bounded — one compiled program per distinct (step kind, bucket plans,
argument shape/dtype signature) — is kept as an observable: every new
signature a step sees is logged once, and `trace_count()` counts those
entries exactly as the reference counts XLA traces, so the port shows
the same bounded set of launch shapes.

`impl` selects the kernel path of the paged attention and of every
bit-plane projection (`kernels.ops.resolve_impl`). A `PimWeight` in the
parameters signs as its planes' and scale's shapes plus `(n_bits,
group)` — the static pair the reference's treedef carries into its jit
key — so quantized serving logs as many signatures as the reference
traces.
`kv_dtype="int8"` builds the quantized-pool variant, whose scale stacks
ride as two extra positional arguments after the pools.

Telemetry hooks (DESIGN.md §13-§14), both off by default and free then:

  * `watcher=` (an `obs.perf.CompileWatcher`): the first call of each new
    signature is reported to `watcher.on_compile` with that call's host
    time, read through `watcher.clock()` — the port's version of the
    reference's per-compile report.
  * `annotate=True`: each bucket launch of a paged attention runs
    inside a `torch.profiler.record_function` range
    `paged_bucket_d{bound}x{count}` (`kernels.paged_common.bucket_scopes`).
    The step itself is named by its caller's span (`serve/paged_prefill`,
    `serve/paged_decode`, `serve/dense_prefill`, `serve/dense_decode`),
    which opens the range of its own name under `ServeTelemetry(
    profile=True)` (DESIGN.md §13).
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.paged_common import bucket_scopes
from ..models import decode_step, decode_step_paged, prefill, prefill_paged
from ..quant.bitplane import PimWeight
from .graphs import DecodeGraphs

#: (step kind, plans) appended once per new step signature
_TRACE_LOG: List[Tuple[str, object]] = []

#: the dtype of every integer tensor a paged step takes (tokens, block
#: tables, block starts, positions, start / total): an input of another
#: dtype signs differently and adds a signature (the dispatch lint's
#: JX005); bucket permutations are index tensors, `PERM_DTYPE`
STEP_INT_DTYPE = torch.int32
PERM_DTYPE = torch.int64


def trace_count(kind: str = None) -> int:
    """Distinct step signatures seen this process, optionally per kind."""
    if kind is None:
        return len(_TRACE_LOG)
    return sum(1 for k, _ in _TRACE_LOG if k == kind)


def _leaf_sig(leaf):
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), str(leaf.dtype))
    if isinstance(leaf, (tuple, list)):
        return tuple(_leaf_sig(x) for x in leaf)
    if isinstance(leaf, dict):
        return tuple((k, _leaf_sig(v)) for k, v in sorted(leaf.items()))
    if isinstance(leaf, PimWeight):
        return ("PimWeight", _leaf_sig(leaf.planes), _leaf_sig(leaf.scale),
                leaf.n_bits, leaf.group)
    if isinstance(leaf, int):
        return ("int",)             # a dynamic scalar (e.g. last_pos)
    return ("py", type(leaf).__name__)


class ServeStep:
    """One serve step of kind `kind`: calls `fn` and logs each new
    (plans, signature) once — the analog of one trace of the reference's
    jitted step — and reports it to `watcher` when one is attached. With
    `annotate`, each bucket launch of the call opens its profiler range.
    With `graphs` (a `serve.graphs.DecodeGraphs`), calls it applies to
    run from its CUDA graphs."""

    def __init__(self, kind: str, fn, watcher=None, annotate: bool = False,
                 graphs=None):
        self.kind = kind
        self._fn = fn
        self._seen = set()
        self._watcher = watcher
        self._annotate = annotate
        self.graphs = graphs

    def __call__(self, *args, perms=None, plans=None):
        sig = _leaf_sig(args)
        key = (plans, (sig, _leaf_sig(perms)))
        if key in self._seen:
            return self._run(sig, args, perms, plans)
        self._seen.add(key)
        _TRACE_LOG.append((self.kind, plans))
        if self._watcher is None:
            return self._run(sig, args, perms, plans)
        t0 = self._watcher.clock()
        out = self._run(sig, args, perms, plans)
        self._watcher.on_compile(self.kind, plans,
                                 self._watcher.clock() - t0)
        return out

    def _run(self, sig, args, perms, plans):
        with bucket_scopes() if self._annotate else contextlib.nullcontext():
            if self.graphs is not None and self.graphs.applies(args):
                return self.graphs(sig, args, perms=perms, plans=plans)
            return self._fn(*args, perms=perms, plans=plans)

    def cache_size(self) -> int:
        return len(self._seen)


def paged_prefill_step(cfg: ModelConfig, impl: str = "auto",
                       kv_dtype: str = "bf16", watcher=None,
                       annotate: bool = False) -> ServeStep:
    """(params, toks, k_pages, v_pages, block_tables, block_starts, start,
    total, last_pos, perms=..., plans=...) -> (logits, k_pages, v_pages),
    pools updated in place. `kv_dtype="int8"`: (params, toks, k_pages,
    v_pages, k_scales, v_scales, bt, st, start, total, last_pos, ...) ->
    (logits, k_pages, v_pages, k_scales, v_scales)."""

    if kv_dtype == "int8":
        def qfn(p, toks, kp, vp, ks, vs, bt, st, strt, tot, lp,
                perms=None, plans=None):
            return prefill_paged(
                p, toks, kp, vp, bt, strt, tot, cfg, last_pos=lp,
                impl=impl, bucket_plan=plans, bucket_perm=perms,
                block_start=st, k_scales=ks, v_scales=vs,
            )
        return ServeStep("prefill", qfn, watcher, annotate)

    def fn(p, toks, kp, vp, bt, st, strt, tot, lp, perms=None, plans=None):
        return prefill_paged(
            p, toks, kp, vp, bt, strt, tot, cfg, last_pos=lp, impl=impl,
            bucket_plan=plans, bucket_perm=perms, block_start=st,
        )
    return ServeStep("prefill", fn, watcher, annotate)


def paged_decode_step(cfg: ModelConfig, impl: str = "auto",
                      kv_dtype: str = "bf16", watcher=None,
                      annotate: bool = False) -> ServeStep:
    """(params, token, k_pages, v_pages, block_tables, block_starts,
    positions, perms=..., plans=...) -> (logits, k_pages, v_pages), pools
    updated in place; the int8 variant takes and returns the scale
    stacks after the pools. On the card's kernel path the calls run
    from piecewise CUDA graphs (`serve.graphs`), with the same
    results."""

    if kv_dtype == "int8":
        def fn(p, t, kp, vp, ks, vs, bt, st, pos, perms=None, plans=None):
            return decode_step_paged(
                p, t, kp, vp, bt, pos, cfg, impl=impl,
                bucket_plan=plans, bucket_perm=perms, block_start=st,
                k_scales=ks, v_scales=vs,
            )
    else:
        def fn(p, t, kp, vp, bt, st, pos, perms=None, plans=None):
            return decode_step_paged(
                p, t, kp, vp, bt, pos, cfg, impl=impl,
                bucket_plan=plans, bucket_perm=perms, block_start=st,
            )
    return ServeStep("decode", fn, watcher, annotate,
                     graphs=DecodeGraphs(cfg, fn, impl, watcher))


def dense_prefill_step(cfg: ModelConfig, cache_len: int, impl: str = "auto",
                       watcher=None, annotate: bool = False) -> ServeStep:
    """(params, toks) -> (logits, cache): the prompt batch prefilled into
    a new dense cache of `cache_len` rows (`models.prefill`)."""

    def fn(p, toks, perms=None, plans=None):
        return prefill(p, toks, cfg, cache_len, impl=impl)
    return ServeStep("dense_prefill", fn, watcher, annotate)


def dense_decode_step(cfg: ModelConfig, impl: str = "auto", watcher=None,
                      annotate: bool = False) -> ServeStep:
    """(params, token, cache) -> (logits, cache): one dense decode step
    (`models.decode_step`), the cache's K/V written in place."""

    def fn(p, t, cache, perms=None, plans=None):
        return decode_step(p, t, cache, cfg, impl=impl)
    return ServeStep("dense_decode", fn, watcher, annotate)
