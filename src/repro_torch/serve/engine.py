"""Serving engine: counterpart of `ServeConfig` and `ServeEngine` of
`repro.serve.engine`.

`generate` runs a [B, T] prompt batch end to end: a whole-batch prefill,
then one-token decode steps.

  * `paged=False` (the default): the dense pre-allocated cache of
    `max_cache_len` rows, whose write position starts at T and is
    shared by every row. Past `max_cache_len` the decode writes clamp to
    the last row, as the reference's do.
  * `paged=True`: the block-paged cache; the prefill goes straight into
    the page pools (chunked when `prefill_chunk > 0`).

`eos_token >= 0` stops a row at that token (kept in the output);
stopped rows are padded with it (in paged mode they also release their
pages at once), and generation returns when every row has stopped — so
the returned width is the number of decode iterations run.

`quantize(qcfg)` converts the projection weights to PIM bit-plane
`PimWeight`s (K5 packs them on the card); `generate` and the
`ContinuousBatcher` take the quantized parameters as they are, and every
projection then runs on K3/K4.

`telemetry=` (an `obs.ServeTelemetry`) gets the reference's hooks in the
reference's order: each batch row is submitted and admitted at once,
every prefill (each chunk, in paged mode) and decode step is accounted,
each row's first token and finish are traced, and each decode step ends
a tick (with the pool gauges, in paged mode). Each `generate` call's
rows take fresh trace uids.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.ops import bucket_args_grouped, resolve_bucket_strategy
from ..models.common import resolve_device
from ..quant.bitplane import (
    PimQuantConfig,
    quantize_tree,
    tree_packed_fraction,
)
from .compiled import (
    dense_decode_step,
    dense_prefill_step,
    paged_decode_step,
    paged_prefill_step,
)
from .paged_cache import PagedKVCache


@dataclasses.dataclass
class ServeConfig:
    max_cache_len: int = 512
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    eos_token: int = -1       # -1 = never stop early
    paged: bool = False       # block-paged KV cache (per-slot positions)
    block_size: int = 16      # KV page size in tokens
    #: kernel path of the paged attention and of every bit-plane
    #: projection (ops.resolve_impl)
    kernel_impl: str = "auto"
    #: "pow2" bounds every paged launch at its bucket's page occupancy;
    #: "none" keeps the single full-depth launch
    bucket_strategy: str = "pow2"
    #: KV page-pool storage: "bf16" keeps the compute dtype; "int8"
    #: stores per-page-scaled quantized pages
    kv_dtype: str = "bf16"
    #: > 0 prefills in block-multiple chunks of at most this many tokens
    prefill_chunk: int = 0
    group_pool_slack: Optional[int] = None
    group_blocks: Any = None
    #: where the pools live and the kernels run
    device: str = "cuda"


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 telemetry=None):
        if serve_cfg.kv_dtype != "bf16" and not serve_cfg.paged:
            raise ValueError("kv_dtype='int8' requires paged=True")
        resolve_bucket_strategy(serve_cfg.bucket_strategy)
        self.cfg = cfg
        self.sc = serve_cfg
        self.params = params
        self.device = resolve_device(serve_cfg.device)
        #: observability facade; None = metrics off, and every hook site
        #: guards on it
        self.telemetry = telemetry
        #: monotone uid base, so rows of successive generate() calls get
        #: distinct trace uids
        self._uid_base = 0
        annotate = telemetry is not None and telemetry.profile
        watcher = None if telemetry is None else telemetry.compile_watcher()
        self._prefill = dense_prefill_step(
            cfg, serve_cfg.max_cache_len, impl=serve_cfg.kernel_impl,
            watcher=watcher, annotate=annotate,
        )
        self._decode = dense_decode_step(
            cfg, impl=serve_cfg.kernel_impl, watcher=watcher,
            annotate=annotate,
        )
        self._decode_paged = paged_decode_step(
            cfg, impl=serve_cfg.kernel_impl, kv_dtype=serve_cfg.kv_dtype,
            watcher=watcher, annotate=annotate,
        )
        self._prefill_paged = paged_prefill_step(
            cfg, impl=serve_cfg.kernel_impl, kv_dtype=serve_cfg.kv_dtype,
            watcher=watcher, annotate=annotate,
        )

    def _trace_admit(self, b: int, prompt_tokens: int) -> list:
        """Open one trace per batch row: `generate` admits the whole
        batch at once, so submit and admit coincide."""
        uids = list(range(self._uid_base, self._uid_base + b))
        self._uid_base += b
        tel = self.telemetry
        if tel is None:
            return uids
        for slot, uid in enumerate(uids):
            tel.on_submit(uid, prompt_tokens, self.sc.max_new_tokens)
            tel.on_admit(uid, slot)
        return uids

    def quantize(self, qcfg: Optional[PimQuantConfig] = None) -> float:
        """Convert projection weights to PIM-resident bit-planes; returns
        the packed fraction of the parameter bytes."""
        qcfg = qcfg or PimQuantConfig(
            n_bits=self.cfg.quant_bits, group=self.cfg.quant_group,
            min_features=1,
        )
        self.params = quantize_tree(self.params, qcfg)
        self.packed_fraction = tree_packed_fraction(self.params)
        return self.packed_fraction

    def generate(self, prompts, rng: Optional[torch.Generator] = None):
        """Greedy (or temperature, with `rng`) generation for a [B, T]
        prompt batch; returns [B, n] int32 tokens on the engine's device,
        n <= max_new_tokens."""
        prompts = torch.as_tensor(prompts, dtype=torch.int32).to(self.device)
        if self.sc.paged:
            return self._generate_paged(prompts, rng)
        b, t = prompts.shape
        tel = self.telemetry
        uids = self._trace_admit(b, t) if tel is not None else None
        logits, cache = self._prefill(self.params, prompts)
        out = []
        done = np.zeros((b,), bool)
        tok = self._sample(logits[:, -1], rng)
        if tel is not None:
            for uid in uids:
                tel.on_prefill(uid, t)
                tel.on_first_token(uid)
        for i in range(self.sc.max_new_tokens):
            tok = self._pad_done(tok, done)
            out.append(tok)
            newly = ~done & self._eos_hits(tok)
            done = done | newly
            if tel is not None:
                for r in np.flatnonzero(newly):
                    tel.on_finish(uids[r])
            if done.all() or i == self.sc.max_new_tokens - 1:
                break  # the last token needs no follow-up decode
            logits, cache = self._decode(self.params, tok, cache)
            if tel is not None:
                tel.on_decode([uids[r] for r in np.flatnonzero(~done)])
                tel.end_tick(0, int((~done).sum()))
            tok = self._sample(logits[:, -1], rng)
        if tel is not None:
            for r in np.flatnonzero(~done):
                tel.on_finish(uids[r])  # rows that ran to the budget
        return torch.cat(out, dim=-1)

    def _eos_hits(self, tok: torch.Tensor) -> np.ndarray:
        if self.sc.eos_token < 0:
            return np.zeros((tok.shape[0],), bool)
        return tok[:, 0].cpu().numpy() == self.sc.eos_token

    def _pad_done(self, tok: torch.Tensor, done: np.ndarray):
        """Rows that already stopped keep emitting EOS (output padding)."""
        if self.sc.eos_token < 0 or not done.any():
            return tok
        mask = torch.tensor(done, device=tok.device)[:, None]
        return torch.where(mask, self.sc.eos_token, tok).to(torch.int32)

    def _generate_paged(self, prompts, rng):
        b, t = prompts.shape
        bs = self.sc.block_size
        tel = self.telemetry
        uids = self._trace_admit(b, t) if tel is not None else None
        pc = PagedKVCache(
            self.cfg, n_slots=b, max_len=self.sc.max_cache_len,
            block_size=bs, kv_dtype=self.sc.kv_dtype,
            prefill_chunk=self.sc.prefill_chunk,
            group_pool_slack=self.sc.group_pool_slack,
            group_blocks=self.sc.group_blocks, device=self.device,
        )
        # whole-batch prefill, chunked when prefill_chunk > 0: every row
        # advances through the same [start, end) spans
        chunk = pc.prefill_chunk or t
        zeros = torch.zeros((b,), dtype=torch.int32, device=self.device)
        logits = None
        start = 0
        while start < t:
            end = min(start + chunk, t)
            n = end - start
            pad = -(-n // bs) * bs
            for i in range(b):
                pc.begin_append(i, start, n)
            toks = torch.nn.functional.pad(prompts[:, start:end],
                                           (0, pad - n))
            eff = np.full((b,), end)
            plans, perms = self._bucket_args(pc, eff)
            if tel is not None:
                tel.account_paged_launch(
                    "prefill", plans, b, pc, eff_lengths=eff,
                    strategy=self.sc.bucket_strategy,
                    kernel_impl=self.sc.kernel_impl,
                )
            pools = (pc.k_pages, pc.v_pages) + (
                (pc.k_scales, pc.v_scales) if pc.quantized else ()
            )
            logits = self._prefill_paged(
                self.params, toks, *pools,
                pc.device_block_tables(), pc.device_block_starts(),
                zeros + start, zeros + end, n - 1, perms=perms, plans=plans,
            )[0]
            pc.lengths[:] = end
            if tel is not None:
                for uid in uids:
                    tel.on_prefill(uid, pad)
            start = end
        out = []
        done = np.zeros((b,), bool)
        tok = self._sample(logits[:, -1], rng)
        if tel is not None:
            for uid in uids:
                tel.on_first_token(uid)
        for it in range(self.sc.max_new_tokens):
            tok = self._pad_done(tok, done)
            out.append(tok)
            for i in np.flatnonzero(self._eos_hits(tok) & ~done):
                # a stopped row releases its pages; its table falls back to
                # scratch, which absorbs later KV writes
                pc.free_slot(int(i))
                done[i] = True
                if tel is not None:
                    tel.on_finish(uids[i])
            if done.all() or it == self.sc.max_new_tokens - 1:
                break
            for i in range(b):
                if not done[i]:
                    pc.begin_append(i, int(pc.lengths[i]), 1)
            plans, perms = self._bucket_args(pc, pc.lengths + 1)
            if tel is not None:
                tel.account_paged_launch(
                    "decode", plans, b, pc, eff_lengths=pc.lengths + 1,
                    strategy=self.sc.bucket_strategy,
                    kernel_impl=self.sc.kernel_impl,
                )
            pools = (pc.k_pages, pc.v_pages) + (
                (pc.k_scales, pc.v_scales) if pc.quantized else ()
            )
            logits = self._decode_paged(
                self.params, tok, *pools,
                pc.device_block_tables(), pc.device_block_starts(),
                pc.device_positions(), perms=perms, plans=plans,
            )[0]
            for i in range(b):
                if not done[i]:
                    pc.lengths[i] += 1
            if tel is not None:
                tel.on_decode([uids[r] for r in np.flatnonzero(~done)])
                tel.end_tick(
                    0, int((~done).sum()),
                    pool_gauges=pc.pool_gauges(),
                    dedup=pc.cross_layer_dedup_stats(),
                    occupancy=pc.slot_occupancy(),
                )
            tok = self._sample(logits[:, -1], rng)
        if tel is not None:
            for r in np.flatnonzero(~done):
                tel.on_finish(uids[r])  # rows that ran to the budget
        return torch.cat(out, dim=-1)

    def _bucket_args(self, pc: PagedKVCache, eff_lengths):
        return bucket_args_grouped(
            self.sc.bucket_strategy, self.sc.kernel_impl,
            pc.bucket_needs(eff_lengths), pc.max_blocks_per_slot,
            device=self.device,
        )

    def _sample(self, logits: torch.Tensor, rng) -> torch.Tensor:
        if self.sc.temperature <= 0.0 or rng is None:
            return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        probs = torch.softmax(logits.float() / self.sc.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=rng).to(torch.int32)
