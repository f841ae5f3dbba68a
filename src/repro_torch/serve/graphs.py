"""Piecewise CUDA graphs of the paged decode step (DESIGN.md §18).

On the card an eager paged decode step is a few thousand small launches,
each behind a few host ops, and the host enqueues them slower than the
card runs them. `DecodeGraphs` serves the step
(`serve.compiled.paged_decode_step`) from CUDA graphs captured once per
step signature and cut at each layer's K1 call. For a stack of L
attention layers there are L + 1 pieces:

  piece 0      the embedding and layer 0 up to its K1 call (ln1, the
               q/k/v projections, rotary, the KV page write, the lengths)
  piece l      layer l-1 after its K1 call (`wo`, the residual, ln2, the
               FFN, the residual) and layer l up to its K1 call
  piece L      the last layer's tail, the final norm and the head

K1 runs eagerly between the pieces. Its bucket plan is the tick's
(`ops.make_bucket_plan` over the slots' lengths), so one capture serves
every plan; and it is called through `models.attention`'s module
attributes at call time, so a wrapper set there after the capture (a
profiler range around `paged_attention`, the dispatch lint's plan
recorder) sees every launch. The cut is where the code already divides,
`attention_decode_paged`'s K1 call (`models.attention.K1_CUT`): the layer
loop and the attention stay the one description of the step.

What is static. The step's per-tick inputs (tokens, block tables, block
starts, positions) are copied into buffers of the capture's own before
each replay. The parameters and the pools are the caller's persistent
tensors; their data pointers are part of a capture's key, so a replaced
parameter tree or pool is captured anew and never replayed stale. K1's
output of layer l stays in the tensor the capture's K1 call returned,
which piece l + 1 reads; each replay copies that tick's K1 output into
it. The pieces of one capture allocate from one memory pool
(`torch.cuda.graph_pool_handle()`) and replay in the order captured.

When. The first call of a signature runs the step eagerly on the capture
stream: the warm pass CUDA graphs require. The second captures the
pieces, running each as soon as it is captured and K1 between them, so
it returns the eager step's result and writes the pools once. Every
later call replays. A meter that runs a step once (the roofline's
`count_step`, the dispatch lint) therefore sees the eager step's
dispatches.

What the host saw. A replay launches the pieces' kernels without
passing their Python launchers, so the capture notes what the launchers
did on the host and each replay does it again: every kernel module's
`LAUNCHES` (and K3's `LAUNCHES_WIDE`) grows by the launches captured
(K1's are eager and count themselves), and the host work handed to `each_run` during the capture
(a harness's reading of a step's tensors) runs after every replay. The
kernels' counts therefore add up per step, replayed or not.

Only CUDA tensors on the kernel path (`ops.resolve_impl` gives "cuda")
are graphed; the CPU and the plain versions run the step as before.
"""

from __future__ import annotations

import contextvars
from typing import Callable, Dict, List, Optional

import torch

from ..configs.base import ModelConfig
from ..kernels import (bitplane_gemm, bitplane_gemv, bitplane_grouped, pack,
                       paged_attention, paged_prefill)
from ..kernels.ops import resolve_impl
from ..models import attention
from ..models.transformer import paged_plan_views
from ..quant.bitplane import PimWeight

#: argument positions of the paged decode step copied into static
#: buffers: the tokens, then the block tables, block starts and
#: positions (the pools, and the int8 variant's scales, sit between)
INPUTS = (1, -3, -2, -1)

#: the kernel modules whose `LAUNCHES` a replay adds its captured
#: launches to
KERNELS = (paged_attention, paged_prefill, bitplane_gemv, bitplane_gemm,
           pack, bitplane_grouped)
#: (module, counter) of every host launch count a replay adds to: each
#: module's `LAUNCHES`, then K3's launches on its wide tile
COUNTERS = tuple((m, "LAUNCHES") for m in KERNELS) + (
    (bitplane_gemv, "LAUNCHES_WIDE"),)

#: the capture in progress (`_Pieces`), for `each_run`
_CAPTURE = contextvars.ContextVar("decode_graph_capture", default=None)


def each_run(fn: Callable[[], None]) -> None:
    """Host work that belongs to one run of a step, such as a reading of
    the step's tensors: `fn()` runs now, or, called while a decode graph
    is captured, once the captured step has run and again after every
    replay of it, when the tensors it holds carry that replay's
    values."""
    pieces = _CAPTURE.get()
    if pieces is None:
        fn()
    else:
        pieces.effects.append(fn)


def _pointers(leaf, out: List[int]) -> List[int]:
    """The data pointers of every tensor in `leaf`, in tree order."""
    if isinstance(leaf, torch.Tensor):
        out.append(leaf.data_ptr())
    elif isinstance(leaf, (tuple, list)):
        for x in leaf:
            _pointers(x, out)
    elif isinstance(leaf, dict):
        for k in sorted(leaf):
            _pointers(leaf[k], out)
    elif isinstance(leaf, PimWeight):
        out.extend((leaf.planes.data_ptr(), leaf.scale.data_ptr()))
    return out


class _Pieces:
    """One capture: `graphs[l]` runs up to layer l's K1 call, `k1[l]` is
    that call and the tensor its output stays in; `graphs[L]` is the
    rest of the step. `launches` holds, per counter of `COUNTERS`, the
    launches captured in the pieces; `effects` the host work handed to
    `each_run`."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.k1: List[tuple] = []
        self.launches = [0] * len(COUNTERS)
        self.effects: List[Callable[[], None]] = []
        self._open: Optional[torch.cuda.CUDAGraph] = None
        self._at: List[int] = []

    def begin(self) -> None:
        self._at = [getattr(m, c) for m, c in COUNTERS]
        self._open = torch.cuda.CUDAGraph()
        self._open.capture_begin(pool=self.pool)

    def end(self) -> None:
        """Close the open piece and run it."""
        graph, self._open = self._open, None
        graph.capture_end()
        self.launches = [n + getattr(m, c) - a for n, (m, c), a
                         in zip(self.launches, COUNTERS, self._at)]
        self.graphs.append(graph)
        graph.replay()

    def abort(self) -> None:
        """Close a piece left open by a step that raised."""
        if self._open is not None:
            graph, self._open = self._open, None
            graph.capture_end()

    def cut(self, call, plans, perms, plan_class):
        """At layer l's K1 call: run piece l, then K1 on this call's
        plans, and open piece l + 1."""
        self.end()
        out = attention._select_bucket_plan(call, plans, perms, plan_class)
        self.k1.append((call, out))
        self.begin()
        return out

    def ran(self, replayed: bool) -> None:
        """After a run of the step: the captured launches counted again
        (a replay), and the host work of `each_run`."""
        if replayed:
            for (m, c), n in zip(COUNTERS, self.launches):
                setattr(m, c, getattr(m, c) + n)
        for fn in self.effects:
            fn()


class _Entry:
    """A signature's state: the pointers it was first called with, and
    after the second call its capture."""

    def __init__(self, pointers: List[int]):
        self.pointers = pointers
        self.pieces: Optional[_Pieces] = None
        self.static: list = []
        self.logits: Optional[torch.Tensor] = None
        self.rest: tuple = ()
        self.capacity = 0


class DecodeGraphs:
    """Serves the calls of one paged decode step (`fn`, called as
    `fn(params, token, k_pages, v_pages[, k_scales, v_scales],
    block_tables, block_starts, positions, perms=, plans=)`) from
    piecewise CUDA graphs, one capture per argument signature.
    `watcher` (an `obs.perf.CompileWatcher`) hears of each capture and
    replay."""

    def __init__(self, cfg: ModelConfig, fn, impl: str, watcher=None):
        self._cfg = cfg
        self._fn = fn
        self._impl = impl
        self._watcher = watcher
        self._entries: Dict[tuple, _Entry] = {}
        self._stream: Optional[torch.cuda.Stream] = None

    def applies(self, args) -> bool:
        """Graphed: CUDA tensors on the kernel path."""
        token = args[1]
        return token.is_cuda and resolve_impl(self._impl,
                                              token.device) == "cuda"

    def __call__(self, sig, args, perms=None, plans=None):
        """One step call; `sig` is the arguments' signature
        (`serve.compiled._leaf_sig(args)`)."""
        inputs = {i % len(args) for i in INPUTS}
        persistent = [a for i, a in enumerate(args) if i not in inputs]
        pointers = _pointers(persistent, [])
        entry = self._entries.get(sig)
        if entry is None or entry.pointers != pointers:
            self._entries[sig] = _Entry(pointers)
            return self._warm(args, perms, plans)
        if entry.pieces is None:
            return self._capture(entry, args, perms, plans)
        return self._replay(entry, args, perms, plans)

    def _streams(self, device):
        """(the caller's stream, the capture stream), the latter after
        everything enqueued on the former."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        self._stream.wait_stream(current)
        return current, self._stream

    def _warm(self, args, perms, plans):
        current, side = self._streams(args[1].device)
        with torch.cuda.stream(side):
            out = self._fn(*args, perms=perms, plans=plans)
        current.wait_stream(side)
        out[0].record_stream(current)
        return out

    def _capture(self, entry, args, perms, plans):
        static = list(args)
        for i in INPUTS:
            static[i] = args[i].clone()
        current, side = self._streams(args[1].device)
        pieces = _Pieces()
        with torch.cuda.stream(side):
            pieces.begin()
            tokens = attention.K1_CUT.set(pieces.cut), _CAPTURE.set(pieces)
            try:
                out = self._fn(*static, perms=perms, plans=plans)
            except BaseException:
                pieces.abort()
                raise
            finally:
                attention.K1_CUT.reset(tokens[0])
                _CAPTURE.reset(tokens[1])
            pieces.end()
        current.wait_stream(side)
        pieces.ran(replayed=False)
        entry.pieces, entry.static = pieces, static
        entry.logits, entry.rest = out[0], tuple(out[1:])
        entry.capacity = static[-3].shape[-1] * static[2].shape[2]
        if self._watcher is not None:
            self._watcher.on_graph("decode", replayed=False)
        return (entry.logits.clone(),) + entry.rest

    def _replay(self, entry, args, perms, plans):
        for i in INPUTS:
            entry.static[i].copy_(args[i])
        plans, perms, cls = paged_plan_views(self._cfg, plans, perms,
                                             entry.capacity)
        select = attention._select_bucket_plan
        pieces = entry.pieces
        for graph, (call, out), c in zip(pieces.graphs, pieces.k1, cls):
            graph.replay()
            out.copy_(select(call, plans, perms, c))
        pieces.graphs[-1].replay()
        pieces.ran(replayed=True)
        if self._watcher is not None:
            self._watcher.on_graph("decode", replayed=True)
        return (entry.logits.clone(),) + entry.rest
