"""Request-lifecycle tracing + the serving telemetry facade: counterpart
of `repro.obs.tracing`.

`ServeTelemetry` is the ONE object the serve stack talks to: the
scheduler and engine call its `on_*` hooks at lifecycle transitions
(submit → admit → prefill → first-token → decode → finish), per paged
kernel launch, and once at the end of every tick. It fans the
observations out into

  * a `RequestTrace` per request (exact TTFT/TPOT/queue-delay, token
    and decode-event counts),
  * `MetricsRegistry` counters/gauges/histograms under the
    `serve_*` / `pool_*` / `kernel_*` naming scheme (DESIGN.md §13),
  * structured events in the JSON-lines `EventLog`,
  * per-tick series (streamed bytes, occupancy).

Every hook is host arithmetic on host values; nothing here touches a
tensor, so a hook never waits for the card. The callers take the
timestamps that close a span (first token, finish, end of tick) after
the tick's own host sync, so on the card TTFT and TPOT measure finished
work, not dispatch. The metrics-off contract lives in the callers: with
`telemetry=None` the serve path makes no call into this package
(`metrics.mutation_count()` stays flat).

Clock discipline: all timestamps come from `self.clock` (shared with
the registry and event log); a `ManualClock` makes every histogram
bit-deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.tpu_gold import H100_SXM, ChipSpec
from ..kernels.ops import grouped_streamed_pages
from .events import EventLog
from .metrics import MetricsRegistry
from .perf import CompileWatcher, PerfModel

_PCTS = (50.0, 90.0, 99.0)


@dataclasses.dataclass
class RequestTrace:
    """Span record of one request's lifecycle (exact, not bucketed)."""

    uid: int
    submit_ts: float
    prompt_tokens: int = 0
    max_new_tokens: int = 0
    slot: int = -1
    admit_ts: Optional[float] = None
    first_token_ts: Optional[float] = None
    finish_ts: Optional[float] = None
    #: prompt tokens served from the prefix index (skipped compute)
    cached_tokens: int = 0
    #: tokens actually run through prefill compute (padded suffix)
    prefill_tokens: int = 0
    #: decode-step tokens traced (excludes the prefill-produced token)
    decode_events: int = 0
    #: total output tokens traced (first token + decode events)
    tokens_out: int = 0

    @property
    def queue_delay_s(self) -> Optional[float]:
        if self.admit_ts is None:
            return None
        return self.admit_ts - self.submit_ts

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.submit_ts

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token after the first; None for
        single-token requests (no decode interval exists)."""
        if self.finish_ts is None or self.first_token_ts is None \
                or self.tokens_out <= 1:
            return None
        return (self.finish_ts - self.first_token_ts) / (self.tokens_out - 1)


def _pct_summary(values: Sequence[float]) -> Dict[str, object]:
    """Exact interpolated percentiles over the sample list."""
    vals = [v for v in values if v is not None]
    if not vals:
        return {"n": 0, "p50": None, "p90": None, "p99": None,
                "mean": None}
    arr = np.asarray(sorted(vals), dtype=np.float64)
    p50, p90, p99 = (float(np.percentile(arr, q)) for q in _PCTS)
    return {"n": len(vals), "p50": p50, "p90": p90, "p99": p99,
            "mean": float(arr.mean())}


class ServeTelemetry:
    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 events: Optional[EventLog] = None, clock=None,
                 events_path: Optional[str] = None,
                 profile: bool = False,
                 chip: Optional[ChipSpec] = None):
        if registry is None:
            registry = MetricsRegistry(clock=clock)
        self.registry = registry
        self.clock = clock if clock is not None else registry.clock
        if events is None:
            events = EventLog(path=events_path, clock=self.clock)
        self.events = events
        #: wrap the serve steps and each bucket launch in
        #: `torch.profiler.record_function` ranges — read by the step
        #: factories (`serve.compiled`)
        self.profile = profile
        #: device spec the roofline predictions are priced against
        self.chip = chip if chip is not None else H100_SXM
        #: predicted-vs-measured launch model (DESIGN.md §14)
        self.perf = PerfModel(registry, self.chip)
        self._compile_watcher: Optional[CompileWatcher] = None
        self.traces: Dict[int, RequestTrace] = {}
        #: per-tick series the benchmarks publish directly
        self.tick_streamed_bytes: List[int] = []
        self.tick_occupancy: List[float] = []
        self._tick_bytes = 0
        # hot metric handles (held, not re-looked-up per event)
        r = registry
        self._c_submitted = r.counter("serve_requests_submitted")
        self._c_finished = r.counter("serve_requests_finished")
        self._c_prefill = r.counter("serve_prefill_tokens")
        self._c_cached = r.counter("serve_prefix_cached_tokens")
        self._c_decode = r.counter("serve_decode_tokens")
        self._c_ticks = r.counter("serve_ticks")
        self._h_queue = r.histogram("serve_queue_delay_s")
        self._h_ttft = r.histogram("serve_ttft_s")
        self._h_tpot = r.histogram("serve_tpot_s")
        self._h_e2e = r.histogram("serve_e2e_latency_s")
        self._c_bytes = r.counter("kernel_streamed_bytes")
        self._c_pages = r.counter("kernel_streamed_pages")

    # -- request lifecycle -------------------------------------------------

    def on_submit(self, uid: int, prompt_tokens: int,
                  max_new_tokens: int) -> None:
        self.traces[uid] = RequestTrace(
            uid=uid, submit_ts=self.clock(),
            prompt_tokens=prompt_tokens, max_new_tokens=max_new_tokens,
        )
        self._c_submitted.inc()
        self.events.emit("submit", uid=uid, prompt_tokens=prompt_tokens,
                         max_new_tokens=max_new_tokens)

    def _trace(self, uid: int) -> RequestTrace:
        tr = self.traces.get(uid)
        if tr is None:  # submitted before telemetry attached
            tr = RequestTrace(uid=uid, submit_ts=self.clock())
            self.traces[uid] = tr
        return tr

    def on_admit(self, uid: int, slot: int, cached_tokens: int = 0
                 ) -> None:
        tr = self._trace(uid)
        tr.admit_ts = self.clock()
        tr.slot = slot
        tr.cached_tokens = cached_tokens
        self._h_queue.observe(tr.queue_delay_s)
        if cached_tokens:
            self._c_cached.inc(cached_tokens)
        self.events.emit("admit", uid=uid, slot=slot,
                         queue_delay_s=round(tr.queue_delay_s, 6),
                         cached_tokens=cached_tokens)

    def on_prefill(self, uid: int, prefill_tokens: int) -> None:
        tr = self._trace(uid)
        tr.prefill_tokens += prefill_tokens
        self._c_prefill.inc(prefill_tokens)
        self.events.emit("prefill", uid=uid,
                         prefill_tokens=prefill_tokens,
                         cached_tokens=tr.cached_tokens)

    def on_first_token(self, uid: int) -> None:
        tr = self._trace(uid)
        tr.first_token_ts = self.clock()
        tr.tokens_out += 1
        self._h_ttft.observe(tr.ttft_s)
        self.events.emit("first_token", uid=uid,
                         ttft_s=round(tr.ttft_s, 6))

    def on_decode(self, uids: Sequence[int]) -> None:
        """One decode tick advanced these requests by one token each."""
        if not uids:
            return
        for uid in uids:
            tr = self._trace(uid)
            tr.decode_events += 1
            tr.tokens_out += 1
        self._c_decode.inc(len(uids))
        self.events.emit("decode", uids=list(uids))

    def on_finish(self, uid: int) -> None:
        tr = self._trace(uid)
        tr.finish_ts = self.clock()
        self._c_finished.inc()
        tpot = tr.tpot_s
        if tpot is not None:
            self._h_tpot.observe(tpot)
        if tr.ttft_s is not None:
            self._h_e2e.observe(tr.finish_ts - tr.submit_ts)
        self.events.emit(
            "finish", uid=uid, tokens_out=tr.tokens_out,
            decode_events=tr.decode_events,
            ttft_s=None if tr.ttft_s is None else round(tr.ttft_s, 6),
            tpot_s=None if tpot is None else round(tpot, 6),
        )

    # -- kernel launches ---------------------------------------------------

    def on_launch(self, kind: str, pages: int, nbytes: int) -> None:
        """Account one paged-kernel dispatch (all its bucket launches)."""
        self.registry.counter("kernel_launches", {"kind": kind}).inc()
        self.registry.counter(
            "kernel_streamed_bytes", {"kind": kind}
        ).inc(nbytes)
        self._c_pages.inc(pages)
        self._c_bytes.inc(nbytes)
        self._tick_bytes += nbytes

    def account_paged_launch(self, kind: str, plans, n_rows: int,
                             pcache, eff_lengths=None, slots=None,
                             strategy: Optional[str] = None,
                             kernel_impl: str = "auto") -> None:
        """Streamed-page/byte accounting for one dispatch, derived from
        the bucket plans: per group, the table entries the launch walks
        (`plans=None` = the full-depth walk), weighted by the group's
        layer count and per-layer page bytes. The quantity is
        structural: what the kernels' block walk streams on the card,
        and what the plain version would stream on the CPU.

        With the launch's geometry (`eff_lengths`/`slots`) and dispatch
        policy (`strategy`/`kernel_impl`) the perf model re-predicts the
        launch from pool geometry alone and records the
        predicted-vs-measured model error beside the accounting."""
        pages = grouped_streamed_pages(
            plans, n_rows, pcache.max_blocks_per_slot, len(pcache.pools)
        )
        plb = pcache.page_layer_bytes
        bytes_by_group = [
            len(pool.layers) * pg * plb
            for pool, pg in zip(pcache.pools, pages)
        ]
        self.on_launch(kind, int(sum(pages)), int(sum(bytes_by_group)))
        if eff_lengths is not None and strategy is not None:
            self.perf.record_launch(
                kind, pcache, plans, n_rows, eff_lengths, slots,
                strategy, kernel_impl, [int(p) for p in pages],
                [int(b) for b in bytes_by_group],
            )

    # -- per-tick sampling -------------------------------------------------

    def end_tick(self, queued: int, active: int,
                 pool_gauges: Optional[List[Dict[str, object]]] = None,
                 dedup: Optional[Dict[str, int]] = None,
                 occupancy: Optional[float] = None,
                 prefix: Optional[Dict[str, int]] = None) -> None:
        """Sample the per-tick gauges; flush the tick's streamed-byte
        accumulator into the per-tick series."""
        r = self.registry
        self._c_ticks.inc()
        r.gauge("serve_queue_depth").set(queued)
        r.gauge("serve_active_slots").set(active)
        self.tick_streamed_bytes.append(self._tick_bytes)
        self._tick_bytes = 0
        if pool_gauges is not None:
            for g in pool_gauges:
                lab = {"group": g["gid"]}
                r.gauge("pool_free_pages", lab).set(g["free_pages"])
                r.gauge("pool_unreserved_pages", lab).set(
                    g["unreserved_pages"]
                )
                r.gauge("pool_allocated_pages", lab).set(
                    g["allocated_pages"]
                )
                r.gauge("pool_cow_events", lab).set(g["cow_events"])
                r.gauge("pool_pages_retired", lab).set(
                    g["pages_retired"]
                )
                if "resident_page_bytes" in g:
                    # pinned KV at the pool's TRUE itemsize (int8 pools
                    # report ~half the bf16 bytes)
                    r.gauge("pool_resident_page_bytes", lab).set(
                        g["resident_page_bytes"]
                    )
        if dedup is not None:
            r.gauge("pool_resident_bytes").set(dedup["resident_bytes"])
            r.gauge("pool_deduped_bytes").set(dedup["deduped_bytes"])
            r.gauge("pool_lockstep_equiv_bytes").set(
                dedup["lockstep_equiv_bytes"]
            )
            r.gauge("pool_shared_pages").set(dedup["shared_pages"])
        if occupancy is not None:
            r.gauge("pool_occupancy").set(occupancy)
            self.tick_occupancy.append(occupancy)
        if prefix is not None:
            r.gauge("pool_prefix_retained_pages").set(
                prefix["retained_pages"]
            )
            r.gauge("pool_prefix_nodes").set(prefix["nodes"])
            r.gauge("pool_prefix_hits").set(prefix["hits"])
            r.gauge("pool_prefix_lookups").set(prefix["lookups"])
            r.gauge("pool_prefix_cached_tokens_served").set(
                prefix["cached_tokens_served"]
            )
            r.gauge("pool_prefix_evicted_pages").set(
                prefix["evicted_pages"]
            )

    # -- diagnostics -------------------------------------------------------

    def on_deadlock(self, tick: int, queued: int, finished: int,
                    free_by_group: Dict[int, int],
                    diagnostic: str) -> None:
        """One structured `deadlock` event with per-group free counts
        (the machine-readable twin of the raised exception's message)."""
        self.events.emit(
            "deadlock", tick=tick, queued=queued, finished=finished,
            free_by_group={str(g): n for g, n in free_by_group.items()},
            diagnostic=diagnostic,
        )

    # -- step-signature introspection --------------------------------------

    def compile_watcher(self) -> CompileWatcher:
        """The (lazily created, shared) watcher the step factories report
        new signatures to — attached via the `watcher=` factory kwarg
        (`serve.compiled`). One watcher per telemetry object, so
        `recompiles_total` spans every step of the run."""
        if self._compile_watcher is None:
            self._compile_watcher = CompileWatcher(
                self.registry, self.chip
            )
        return self._compile_watcher

    # -- exporters ---------------------------------------------------------

    @property
    def streamed_bytes_total(self) -> int:
        return self._c_bytes.value + self._tick_bytes

    def lifecycle_counts(self) -> Dict[str, int]:
        return {
            "submitted": self._c_submitted.value,
            "finished": self._c_finished.value,
        }

    def latency_summary(self) -> Dict[str, Dict[str, object]]:
        """Exact (trace-derived) percentile summaries."""
        traces = self.traces.values()
        return {
            "ttft_s": _pct_summary([t.ttft_s for t in traces]),
            "tpot_s": _pct_summary([t.tpot_s for t in traces]),
            "queue_delay_s": _pct_summary(
                [t.queue_delay_s for t in traces]
            ),
            "e2e_s": _pct_summary([
                t.finish_ts - t.submit_ts
                for t in traces if t.finish_ts is not None
            ]),
        }

    def summary(self) -> Dict[str, object]:
        """The run-summary dict exporter (DESIGN.md §13-§14)."""
        out = {
            "requests": {
                **self.lifecycle_counts(),
                "traced": len(self.traces),
            },
            "latency_s": self.latency_summary(),
            "streamed_bytes": {
                "total": self.streamed_bytes_total,
                "per_tick": list(self.tick_streamed_bytes),
            },
            "ticks": self._c_ticks.value,
            "events": len(self.events),
            "metrics": self.registry.summary(),
        }
        if self.perf.phases:
            out["perf"] = self.perf.summary()
        if self._compile_watcher is not None:
            out["recompiles"] = self._compile_watcher.summary()
        return out

    def close(self) -> None:
        self.events.close()
