"""Continuous-batching request scheduler: counterpart of
`repro.serve.scheduler`.

A fixed decode batch of `n_slots`; finished sequences release their slot
and a queued request is prefilled into it. One decode step advances
every slot. Two cache modes:

  dense (`paged=False`, the default): the pre-allocated cache of
  `cache_len` rows per slot with ONE global write position, as in the
  reference. It starts at 0 and moves by one per decode tick; a request
  prefills into a batch-1 cache whose whole row (zeros past the prompt
  included) is copied into its slot, and its prompt position is thrown
  away. So decode writes its KV over the prompt's rows from row 0 on and
  attends to rows <= the global position — the reference's behaviour,
  reproduced exactly (it is what its pinned dense-drain numbers come
  from). Requests must share one (padded) prompt length.

  paged (`paged=True`): KV lives in the block-paged cache
  (`serve.paged_cache`) with per-slot positions, so prompts of any
  length share one decode batch, and prefill writes straight into the
  page pools.

Paged mode only:

  * `prefix=True`: a radix index over full KV pages dedups shared prompt
    prefixes — a hit maps the leading pages refcounted into the slot's
    table and prefill runs on the uncached suffix only (K2 with
    `start > 0`).
  * Admission reserves each request's worst-case page draws in every
    layer group, FIFO among admissible requests; index pages are evicted
    only when nothing is admissible without.
  * `prefill_chunk > 0`: a long uncached suffix prefills in
    block-multiple chunks, one per tick, interleaved with decode; tokens
    equal the single-shot ones.
  * `eos_token >= 0` stops a slot when it emits that token (kept in the
    output); its pages recycle the same tick.
  * Every paged launch goes through the length-bucketed dispatch unless
    `bucket_strategy="none"`, when a kernel path runs (the plain version
    ignores plans, so none are built for it).

`params` may hold PIM bit-plane weights (`ServeEngine.quantize`); they
flow through unchanged, and every projection then runs on K3/K4 (or
their plain versions under `kernel_impl="ref"`). Each tick brings its
argmax to the host once.

`telemetry=` (an `obs.ServeTelemetry`) receives the reference's hooks at
the same transitions and in the same order: submit, admit, prefill and
its launch accounting, first token, decode launch accounting, decode,
finish, end of tick (in paged mode with the pool, dedup, occupancy and
prefix gauges) and deadlock. The hooks read host state only and add no host sync: first
token, finish and end of tick are stamped after the sync the tick
already makes, so on the card they close on finished work. With
`telemetry=None` (the default) the drain makes no call into `obs`.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.ops import bucket_args_grouped, resolve_bucket_strategy
from ..models import init_cache
from ..models.common import resolve_device
from .compiled import (
    dense_decode_step,
    dense_prefill_step,
    paged_decode_step,
    paged_prefill_step,
)
from .paged_cache import PagedKVCache
from .prefix_cache import PrefixIndex


@dataclasses.dataclass
class Request:
    uid: int
    prompt: object               # [T] int token ids (numpy or CPU tensor)
    max_new_tokens: int = 16
    generated: List[int] = dataclasses.field(default_factory=list)
    #: memoized prefix-index block keys — a queued request is re-probed
    #: every admission tick, but its prompt never changes
    block_keys: Optional[List[Tuple[int, ...]]] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


def _insert_batch(cache, one, idx: int):
    """Write the batch-1 dense cache `one` into slot `idx` of `cache`, in
    place: the whole row of every entry — K/V (zeros past the prompt
    included), recurrent states and conv tails, zamba2's shared-block
    K/V — each with its batch on axis 1. The position stays the
    batcher's, as in the reference."""
    for key, full in cache.items():
        if key != "position":
            full[:, idx] = one[key][:, 0]


def _host_tokens(prompt) -> np.ndarray:
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.detach().cpu().numpy()
    return np.asarray(prompt, dtype=np.int32).reshape(-1)


class ContinuousBatcher:
    """Continuous batching over `n_slots` decode slots, on the dense
    pre-allocated cache (`paged=False`, the default) or the block-paged
    one. `prompt_len` is accepted and ignored, as in the reference: the
    dense prefill takes each prompt's own length."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        n_slots: int,
        cache_len: int,
        prompt_len: Optional[int] = None,
        *,
        paged: bool = False,
        block_size: int = 16,
        n_blocks: int = 0,
        prefix: bool = False,
        eos_token: int = -1,
        kernel_impl: str = "auto",
        bucket_strategy: str = "pow2",
        prefix_max_retained_fraction: float = 1.0,
        window_retirement: bool = True,
        kv_dtype: str = "bf16",
        prefill_chunk: int = 0,
        group_pool_slack: Optional[int] = None,
        group_blocks=None,
        telemetry=None,
        device="cuda",
    ):
        if prefix and not paged:
            raise ValueError("prefix sharing requires paged=True")
        if kv_dtype != "bf16" and not paged:
            raise ValueError("kv_dtype='int8' requires paged=True")
        if (prefill_chunk or group_blocks is not None) and not paged:
            raise ValueError(
                "prefill_chunk / group_blocks require paged=True "
                "(chunked prefill and per-group sizing are page-pool "
                "machinery)"
            )
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.paged = paged
        self.device = resolve_device(device)
        self.bucket_strategy = resolve_bucket_strategy(bucket_strategy)
        self._kernel_impl = kernel_impl
        #: -1 = never stop early; >= 0 = a slot that emits this token
        #: finishes immediately and frees its pages the same tick
        self.eos_token = eos_token
        #: observability facade; None = metrics off, and every hook site
        #: below guards on it
        self.telemetry = telemetry
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.tokens = torch.zeros((n_slots, 1), dtype=torch.int32,
                                  device=self.device)
        self.finished: Dict[int, List[int]] = {}
        self.ticks = 0
        #: prompt tokens run through prefill compute (padded suffix
        #: lengths — prefix hits shrink this)
        self.prefill_tokens = 0
        self.kv_dtype = kv_dtype
        self.prefix = (
            PrefixIndex(
                block_size,
                max_retained_fraction=prefix_max_retained_fraction,
            )
            if prefix else None
        )
        annotate = telemetry is not None and telemetry.profile
        watcher = None if telemetry is None else telemetry.compile_watcher()
        if paged:
            self.pcache = PagedKVCache(
                cfg, n_slots, max_len=cache_len, block_size=block_size,
                n_blocks=n_blocks, window_retirement=window_retirement,
                kv_dtype=kv_dtype, prefill_chunk=prefill_chunk,
                group_pool_slack=group_pool_slack,
                group_blocks=group_blocks, device=self.device,
            )
            self.cache = None
            self._decode_paged = paged_decode_step(
                cfg, impl=kernel_impl, kv_dtype=kv_dtype, watcher=watcher,
                annotate=annotate,
            )
            self._prefill_paged = paged_prefill_step(
                cfg, impl=kernel_impl, kv_dtype=kv_dtype, watcher=watcher,
                annotate=annotate,
            )
            #: block-rounded chunk width of chunked prefill (0 = one shot)
            self.prefill_chunk = self.pcache.prefill_chunk
        else:
            self.pcache = None
            self.cache = init_cache(cfg, n_slots, cache_len, self.device)
            self._decode = dense_decode_step(
                cfg, impl=kernel_impl, watcher=watcher, annotate=annotate,
            )
            self._prefill_dense = dense_prefill_step(
                cfg, cache_len, impl=kernel_impl, watcher=watcher,
                annotate=annotate,
            )
            self.prefill_chunk = 0
        #: slot -> next un-prefilled prompt position of an in-flight
        #: chunked prefill; such a slot is parked out of the decode batch
        self._chunk_pos: Dict[int, int] = {}

    def submit(self, req: Request):
        """Queue `req`; its prompt is kept as host int32 token ids."""
        req.prompt = _host_tokens(req.prompt)
        self.queue.append(req)
        if self.telemetry is not None:
            self.telemetry.on_submit(
                req.uid, int(req.prompt.shape[0]), req.max_new_tokens
            )

    # -- prefill -----------------------------------------------------------

    def _fill_slots(self):
        for i in range(self.n_slots):
            # a request can complete AT prefill: its pages free at once
            # and the same slot is retried within this tick
            while self.slots[i] is None and self.queue:
                if not self.paged:
                    self._prefill_into_dense(i, self.queue.popleft())
                    continue
                admitted = self._admit_paged(i)
                if admitted is None:
                    return
                req, attach_plan, n_cached = admitted
                self._prefill_into_paged(i, req, attach_plan, n_cached)

    # -- paged admission (reservation + prefix lookup) -----------------------

    def _try_reserve(self, slot: int, req: Request):
        """Reserve worst-case pages (prompt + decode growth + COW) in every
        layer group after a prefix lookup. Returns `(attach_plan,
        n_cached)` on success, else the per-group draw-deficit dict."""
        pc = self.pcache
        t = int(req.prompt.shape[0])
        total = t + max(req.max_new_tokens - 1, 0)
        attach_plan = None
        n_cached, cow = 0, False
        if self.prefix is not None:
            if req.block_keys is None:
                req.block_keys = self.prefix.block_keys(req.prompt)
            chain = self.prefix.lookup_chain(
                req.prompt, keys=req.block_keys
            )
            n_cached, cow = self.prefix.split_prompt(req.prompt, chain)
            if n_cached:
                nbh = -(-n_cached // pc.block_size)
                attach_plan = pc.plan_attach(
                    [n.pages for n in chain[:nbh]], n_cached
                )
                if attach_plan is None:
                    n_cached, cow = 0, False
        if attach_plan is not None and n_cached:
            shared, n_cow = pc.attach_plan_counts(attach_plan, cow)
        else:
            attach_plan, shared, n_cow = None, 0, 0
        if pc.reserve_slot(slot, total, n_shared=shared, n_cow=n_cow):
            return attach_plan, n_cached
        return pc.reserve_deficits(total, shared, n_cow)

    def _admit_paged(self, slot: int):
        """First admissible queued request (FIFO among admissible); index
        pages are evicted only when nothing is admissible without."""
        pc = self.pcache
        deficits = []
        for qi in range(len(self.queue)):
            got = self._try_reserve(slot, self.queue[qi])
            if not isinstance(got, dict):
                req = self.queue[qi]
                del self.queue[qi]
                return (req,) + got
            deficits.append(got)
        if self.prefix is None:
            return None
        for qi, deficit in enumerate(deficits):
            if self.prefix.evict(pc, deficit):
                got = self._try_reserve(slot, self.queue[qi])
                if not isinstance(got, dict):
                    req = self.queue[qi]
                    del self.queue[qi]
                    return (req,) + got
        return None

    def _prefill_into_dense(self, i: int, req: Request):
        if self.telemetry is not None:
            self.telemetry.on_admit(req.uid, i)
        toks = torch.tensor(req.prompt[None, :], device=self.device)
        logits, one = self._prefill_dense(self.params, toks)
        _insert_batch(self.cache, one, i)
        t = int(req.prompt.shape[0])
        self.prefill_tokens += t
        if self.telemetry is not None:
            self.telemetry.on_prefill(req.uid, t)
        self._start_slot(i, req, logits)

    def _prefill_into_paged(
        self, i: int, req: Request, attach_plan, n_cached: int
    ):
        """Attach the prefix-hit pages, prefill the uncached suffix (its
        first chunk only when it exceeds `prefill_chunk`), then publish
        the completed blocks back to the index."""
        pc = self.pcache
        t = int(req.prompt.shape[0])
        if self.telemetry is not None:
            self.telemetry.on_admit(req.uid, i, n_cached)
        if attach_plan is not None:
            pc.attach_chain(i, attach_plan)
        if self.prefix is not None:
            self.prefix.lookups += 1
            self.prefix.hits += bool(n_cached)
            self.prefix.cached_tokens_served += n_cached
        if self.prefill_chunk and t - n_cached > self.prefill_chunk:
            end = n_cached + self.prefill_chunk
            self._launch_prefill_chunk(i, req, n_cached, end)
            self._chunk_pos[i] = end
            self.slots[i] = req       # queue-busy, parked out of decode
            return
        logits = self._launch_prefill_chunk(i, req, n_cached, t)
        self._finish_prefill(i, req, logits)

    def _launch_prefill_chunk(self, i: int, req: Request,
                              start: int, end: int):
        """One prefill launch over prompt positions [start, end) of slot
        `i`, padded to a block multiple; the tables are sliced to the
        slot's row and `last_pos` picks the true suffix end."""
        pc = self.pcache
        bs = pc.block_size
        n = end - start
        pad = -(-n // bs) * bs
        # host-side page prep BEFORE the device table snapshot
        pc.begin_append(i, start, n)
        toks = np.zeros((1, pad), np.int32)
        toks[0, :n] = req.prompt[start:end]
        toks = torch.tensor(toks, device=self.device)
        plans, perms = self._bucket_args([end], slots=[i])
        bt, st = pc.device_block_tables(), pc.device_block_starts()
        if bt.dim() == 2:                # single group: [B, mb] / [B]
            bt, st = bt[i: i + 1], st[i: i + 1]
        else:                            # layer-major: [L, B, mb] / [L, B]
            bt, st = bt[:, i: i + 1], st[:, i: i + 1]
        start_t = torch.tensor([start], dtype=torch.int32, device=self.device)
        end_t = torch.tensor([end], dtype=torch.int32, device=self.device)
        if pc.quantized:
            logits = self._prefill_paged(
                self.params, toks, pc.k_pages, pc.v_pages,
                pc.k_scales, pc.v_scales, bt, st, start_t, end_t, n - 1,
                perms=perms, plans=plans,
            )[0]
        else:
            logits = self._prefill_paged(
                self.params, toks, pc.k_pages, pc.v_pages, bt, st,
                start_t, end_t, n - 1, perms=perms, plans=plans,
            )[0]
        pc.lengths[i] = end
        self.prefill_tokens += pad
        if self.telemetry is not None:
            self.telemetry.on_prefill(req.uid, pad)
            # one-slot launch (n_rows 1), accounted from the same pool
            # state the plan was built from
            self.telemetry.account_paged_launch(
                "prefill", plans, 1, pc, eff_lengths=[end], slots=[i],
                strategy=self.bucket_strategy,
                kernel_impl=self._kernel_impl,
            )
        return logits

    def _finish_prefill(self, i: int, req: Request, logits):
        if self.prefix is not None:
            self.prefix.publish(req.prompt, self.pcache, i,
                                keys=req.block_keys)
        self._start_slot(i, req, logits)

    def _advance_chunked(self) -> int:
        """Advance every in-flight chunked prefill by ONE chunk; a slot
        whose final chunk lands gets its first token this tick. Returns
        slots advanced."""
        advanced = 0
        for i in sorted(self._chunk_pos):
            req = self.slots[i]
            pos = self._chunk_pos[i]
            t = int(req.prompt.shape[0])
            end = min(pos + self.prefill_chunk, t)
            logits = self._launch_prefill_chunk(i, req, pos, end)
            advanced += 1
            if end >= t:
                del self._chunk_pos[i]
                self.slots[i] = None  # _finish_prefill re-seats or ends
                self._finish_prefill(i, req, logits)
            else:
                self._chunk_pos[i] = end
        return advanced

    def _hit_eos(self, tok: int) -> bool:
        return self.eos_token >= 0 and tok == self.eos_token

    def _start_slot(self, i: int, req: Request, logits):
        nxt = int(torch.argmax(logits[0, -1]).item())
        req.generated.append(nxt)
        if self.telemetry is not None:
            self.telemetry.on_first_token(req.uid)
        if req.done or self._hit_eos(nxt):
            # the prefill token completes the request: pages free now
            self.finished[req.uid] = req.generated
            if self.paged:
                self.pcache.free_slot(i)
            if self.telemetry is not None:
                self.telemetry.on_finish(req.uid)
            return
        self.tokens[i, 0] = nxt
        self.slots[i] = req

    # -- decode ------------------------------------------------------------

    def step(self) -> int:
        """One tick: advance chunked prefills one chunk each, fill free
        slots, decode once. Returns slots advanced (decode + chunks)."""
        n_finished = len(self.finished)
        chunked = self._advance_chunked() if self._chunk_pos else 0
        self._fill_slots()
        active = [
            i for i, s in enumerate(self.slots)
            if s is not None and i not in self._chunk_pos
        ]
        if not active:
            if chunked or len(self.finished) > n_finished:
                self.ticks += 1
            if self.telemetry is not None:
                self._sample_tick()
            return chunked
        if self.paged:
            nxt = self._step_paged(active)
        else:
            logits, self.cache = self._decode(self.params, self.tokens,
                                              self.cache)
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        host = nxt.tolist()               # the tick's one host sync
        if self.telemetry is not None:
            self.telemetry.on_decode([self.slots[i].uid for i in active])
        for i in active:
            req = self.slots[i]
            tok = int(host[i])
            req.generated.append(tok)
            if req.done or self._hit_eos(tok):
                # pages recycle this very tick, before the next admission
                self.finished[req.uid] = req.generated
                if self.paged:
                    self.pcache.free_slot(i)
                self.slots[i] = None
                if self.telemetry is not None:
                    self.telemetry.on_finish(req.uid)
        self.tokens = nxt[:, None]
        self.ticks += 1
        if self.telemetry is not None:
            self._sample_tick()
        return len(active) + chunked

    def _sample_tick(self):
        """End-of-tick gauge sample (telemetry attached only): queue
        depth, active slots, per-group pool state, dedup bytes,
        occupancy and the prefix index (the last four in paged mode)."""
        tel = self.telemetry
        if tel is None:
            return
        queued = len(self.queue)
        active = sum(s is not None for s in self.slots)
        if not self.paged:
            tel.end_tick(queued, active)
            return
        pc = self.pcache
        tel.end_tick(
            queued, active,
            pool_gauges=pc.pool_gauges(),
            dedup=pc.cross_layer_dedup_stats(),
            occupancy=pc.slot_occupancy(),
            prefix=None if self.prefix is None else self.prefix.stats(),
        )

    def _bucket_args(self, eff_lengths, slots=None):
        """Per-group slot→bucket packing for one launch."""
        return bucket_args_grouped(
            self.bucket_strategy, self._kernel_impl,
            self.pcache.bucket_needs(eff_lengths, slots),
            self.pcache.max_blocks_per_slot, device=self.device,
        )

    def _step_paged(self, active: List[int]) -> torch.Tensor:
        pc = self.pcache
        for i in active:
            # the incoming token's page must exist and be exclusively
            # owned (COW) before the device write
            pc.begin_append(i, int(pc.lengths[i]), 1)
        # parked (mid-chunked-prefill) slots ride the decode like idle
        # slots: a scratch table row takes their unconditional KV write
        eff = pc.lengths + 1
        parked = sorted(self._chunk_pos)
        if parked:
            eff = np.array(eff)
            eff[parked] = 1
        plans, perms = self._bucket_args(eff)
        if self.telemetry is not None:
            self.telemetry.account_paged_launch(
                "decode", plans, self.n_slots, pc, eff_lengths=eff,
                strategy=self.bucket_strategy,
                kernel_impl=self._kernel_impl,
            )
        bt = pc.device_block_tables(scratch_slots=parked)
        st = pc.device_block_starts(scratch_slots=parked)
        pos = pc.device_positions(scratch_slots=parked)
        if pc.quantized:
            logits = self._decode_paged(
                self.params, self.tokens, pc.k_pages, pc.v_pages,
                pc.k_scales, pc.v_scales, bt, st, pos,
                perms=perms, plans=plans,
            )[0]
        else:
            logits = self._decode_paged(
                self.params, self.tokens, pc.k_pages, pc.v_pages,
                bt, st, pos, perms=perms, plans=plans,
            )[0]
        for i in active:
            pc.lengths[i] += 1
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    def _pool_diagnostic(self) -> str:
        """Per-layer-group pool state and the head-of-queue request's
        per-group draw deficit, for the deadlock error ("" in dense
        mode)."""
        if not self.paged:
            return ""
        pc = self.pcache
        per_group = ", ".join(
            f"g{p.gid}[{'global' if p.window is None else f'w={p.window}'}"
            f"×{len(p.layers)}L]: {p.n_free}/{p.n_blocks - 1} free, "
            f"{p.available_blocks()} unreserved, "
            f"{sum(r - p._drawn[s] for s, r in p._reserved.items())}"
            f" draws promised"
            for p in pc.pools
        )
        head = ""
        if self.queue:
            req = self.queue[0]
            t = int(req.prompt.shape[0])
            total = t + max(req.max_new_tokens - 1, 0)
            deficits = pc.reserve_deficits(total)
            short = ", ".join(
                f"g{g}:-{d}" for g, d in sorted(deficits.items())
            ) or "none"
            head = (
                f"; head-of-queue uid={req.uid} needs {total} tokens"
                f" ({t} prompt), per-group draw deficit: {short}"
            )
        return (
            f"; pools: {per_group}{head}; "
            f"occupancy={pc.slot_occupancy():.2f}"
        )

    def run_until_drained(
        self, max_ticks: int = 10_000, strict: bool = True, on_tick=None
    ) -> Dict[int, List[int]]:
        """Drain the queue. Exhausting `max_ticks` with work pending
        raises (strict) or warns. A tick that advances nothing, admits
        nothing and frees no page while requests are queued is a
        deadlock — no future tick can free pages — and raises at once
        with the per-group pool diagnostic."""
        ticks = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and ticks < max_ticks:
            queued_before = len(self.queue)
            free_before = self.pcache.free_state() if self.paged else ()
            advanced = self.step()
            ticks += 1
            if on_tick is not None:
                on_tick(self)
            if (
                advanced == 0
                and self.queue
                and len(self.queue) == queued_before
                and (not self.paged
                     or self.pcache.free_state() == free_before)
            ):
                diagnostic = self._pool_diagnostic()
                if self.telemetry is not None:
                    # the machine-readable twin of the message below
                    self.telemetry.on_deadlock(
                        ticks, len(self.queue), len(self.finished),
                        {p.gid: p.n_free for p in self.pcache.pools}
                        if self.paged else {},
                        diagnostic,
                    )
                raise RuntimeError(
                    f"run_until_drained: deadlock at tick {ticks} — no "
                    f"slot is active and none of the {len(self.queue)} "
                    f"queued requests is admissible, so no future tick "
                    f"can free pages or make progress "
                    f"({len(self.finished)} finished)"
                    f"{diagnostic}"
                )
        pending = len(self.queue) + sum(s is not None for s in self.slots)
        if pending:
            msg = (
                f"run_until_drained: exhausted max_ticks={max_ticks} with "
                f"{len(self.queue)} queued and "
                f"{sum(s is not None for s in self.slots)} active requests "
                f"({len(self.finished)} finished)"
            )
            if strict:
                raise RuntimeError(msg)
            import warnings

            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return self.finished
