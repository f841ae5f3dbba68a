"""Predicted-vs-measured performance attribution (DESIGN.md §14):
counterpart of `repro.obs.perf`.

Every instrumented paged launch records, beside the bytes the dispatch
layer accounts (`ServeTelemetry.account_paged_launch`), three analytic
predictions derived from pool geometry alone:

  full      the single-launch full-depth walk — `n_rows *
            max_blocks_per_slot` table entries per layer group;
  bucketed  what the pow2 plan built from the same live needs streams
            (`kernels.ops.make_bucket_plan` re-derived per group,
            `plan_streamed_pages` summed);
  live      the floor: exactly the live walk entries
            (`PagedKVCache.bucket_needs`), no pow2 padding.

The applicable prediction (bucketed when the dispatch builds plans,
full when it cannot — the plain version, or strategy "none") is compared
to the measured accounting per launch and per layer group; the relative
error lands in `perf_model_error{phase[,group]}` histograms. Both sides
are structural, so the error must be exactly 0: the histograms catch
drift between what the dispatch streams and what the model predicts.

Each prediction also carries a roofline time — `bytes /
ChipSpec.hbm_bandwidth` at `core.tpu_gold.H100_SXM` by default — so the
summary attributes per-phase (prefill vs decode) fractions of the
predicted HBM time.

Two differences from the reference:

  * `plans_enabled` takes the launch device, because the port's impl
    rule does (`kernels.ops.resolve_impl`): plans are built exactly when
    `ops._bucketing_off` says they are not off.
  * Nothing compiles. `CompileWatcher.on_compile` is called by
    `serve.compiled.PagedStep` on the first call of each new step
    signature (what the reference's jit cache counts as one trace), with
    that call's host time read through `watcher.clock()`. There is no
    compiler cost analysis, so `hlo_flops` / `hlo_bytes` are 0, as the
    reference reports for a backend without one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.tpu_gold import H100_SXM, ChipSpec
from ..kernels.ops import (
    is_bucket_plan,
    make_bucket_plan,
    plan_streamed_pages,
    resolve_bucket_strategy,
    resolve_impl,
)
from .metrics import MetricsRegistry

#: relative-error buckets for the model-error histograms: the first
#: bucket (<= 0.1%) is where every in-contract launch must land; the
#: rest measure drift when a change breaks the model
MODEL_ERROR_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
)

#: first-call walltimes of a step signature: 1 ms .. ~65 s, x2 per step
COMPILE_WALLTIME_BUCKETS: Tuple[float, ...] = tuple(
    1e-3 * 2.0 ** i for i in range(17)
)


def plans_enabled(strategy: str, kernel_impl: str, device) -> bool:
    """Whether the serving dispatch builds bucket plans for a launch on
    `device`: strategy `"none"` and the plain version (`ref`, or `auto`
    on a CPU device) never do, so their launches walk the full depth."""
    return (
        resolve_bucket_strategy(strategy) != "none"
        and resolve_impl(kernel_impl, device) != "ref"
    )


def plan_signature(plans) -> str:
    """Compact stable label for a plan combination: `"single"` for the
    everywhere-full-depth walk, `"<bound>x<count>[+...]"` per launch
    bucket, `|`-joined per layer group with `-` for a group that
    degenerated to the single launch."""
    if plans is None:
        return "single"
    if is_bucket_plan(plans):
        return "+".join(f"{b}x{c}" for b, c in plans)
    return "|".join(
        "-" if p is None else "+".join(f"{b}x{c}" for b, c in p)
        for p in plans
    )


def predict_streamed_pages(
    needs, n_rows: int, table_width: int, bucketed: bool = True
) -> int:
    """Pages ONE group's launch walks, predicted from its live walk-entry
    counts alone: re-derive the pow2 plan the dispatch would build
    (`bucketed=True`) or charge the full-depth walk."""
    if not bucketed:
        return n_rows * table_width
    plan, _ = make_bucket_plan(None, 0, table_width, needs=needs)
    return plan_streamed_pages(plan, n_rows, table_width)


@dataclasses.dataclass
class LaunchPrediction:
    """Analytic streamed-byte model of one paged dispatch."""

    phase: str
    n_rows: int
    #: per-layer-group predicted pages under the APPLICABLE policy
    pages_by_group: List[int]
    #: per-group bytes (layer-count- and page-byte-weighted)
    bytes_by_group: List[int]
    #: the three model grades, summed over groups (bytes)
    full_bytes: int
    bucketed_bytes: int
    live_bytes: int

    @property
    def bytes_total(self) -> int:
        return sum(self.bytes_by_group)

    def roofline_s(self, chip: ChipSpec = H100_SXM) -> float:
        """Predicted HBM-bound launch time at the device spec."""
        return self.bytes_total / chip.hbm_bandwidth


def predict_launch(
    pcache,
    eff_lengths,
    slots,
    n_rows: int,
    *,
    strategy: str = "pow2",
    kernel_impl: str = "auto",
) -> LaunchPrediction:
    """Full analytic model of one dispatch from pool geometry: per layer
    group, the live walk-entry counts (`bucket_needs`, window retirement
    folded in), the pow2 plan re-derived from them, and the three byte
    grades. The launch runs where the cache lives (`pcache.device`);
    `phase` is filled by the caller."""
    needs = pcache.bucket_needs(eff_lengths, slots)
    mb = pcache.max_blocks_per_slot
    plb = pcache.page_layer_bytes
    bucketed = plans_enabled(strategy, kernel_impl, pcache.device)
    full_b = bucketed_b = live_b = 0
    pages_by_group: List[int] = []
    bytes_by_group: List[int] = []
    for pool, need in zip(pcache.pools, needs):
        layers = len(pool.layers)
        full_pg = n_rows * mb
        buck_pg = predict_streamed_pages(need, n_rows, mb, bucketed=True)
        live_pg = int(np.asarray(need).sum())
        full_b += layers * full_pg * plb
        bucketed_b += layers * buck_pg * plb
        live_b += layers * live_pg * plb
        pg = buck_pg if bucketed else full_pg
        pages_by_group.append(pg)
        bytes_by_group.append(layers * pg * plb)
    return LaunchPrediction(
        phase="", n_rows=n_rows, pages_by_group=pages_by_group,
        bytes_by_group=bytes_by_group, full_bytes=full_b,
        bucketed_bytes=bucketed_b, live_bytes=live_b,
    )


def _rel_err(predicted: float, measured: float) -> float:
    if measured == 0:
        return 0.0 if predicted == 0 else 1.0
    return abs(predicted - measured) / measured


class PerfModel:
    """Per-launch predicted-vs-measured accounting + phase attribution.

    One instance per `ServeTelemetry`; `record_launch` runs only on the
    instrumented path (the metrics-off contract is the callers')."""

    def __init__(self, registry: MetricsRegistry,
                 chip: ChipSpec = H100_SXM):
        self.registry = registry
        self.chip = chip
        #: per-phase accumulators (exact, host ints) for `summary()`
        self.phases: Dict[str, Dict[str, float]] = {}
        #: every instrumented launch: (phase, plans, n_rows, eff_lengths)
        self.launch_log: List[Tuple[str, object, int, Tuple[int, ...]]] = []

    def _phase(self, phase: str) -> Dict[str, float]:
        st = self.phases.get(phase)
        if st is None:
            st = self.phases[phase] = {
                "launches": 0, "predicted_bytes": 0, "measured_bytes": 0,
                "live_bytes": 0, "full_walk_bytes": 0,
                "bucketed_bytes": 0, "model_error_max": 0.0,
            }
        return st

    def record_launch(
        self,
        phase: str,
        pcache,
        plans,
        n_rows: int,
        eff_lengths,
        slots,
        strategy: str,
        kernel_impl: str,
        measured_pages_by_group: Sequence[int],
        measured_bytes_by_group: Sequence[int],
    ) -> LaunchPrediction:
        """Predict this launch from geometry, compare to the measured
        per-group accounting, and record the model error."""
        pred = predict_launch(
            pcache, eff_lengths, slots, n_rows,
            strategy=strategy, kernel_impl=kernel_impl,
        )
        pred.phase = phase
        r = self.registry
        measured_total = int(sum(measured_bytes_by_group))
        err = _rel_err(pred.bytes_total, measured_total)
        r.histogram(
            "perf_model_error", {"phase": phase},
            bounds=MODEL_ERROR_BUCKETS,
        ).observe(err)
        for pool, pb, mb_ in zip(
            pcache.pools, pred.bytes_by_group, measured_bytes_by_group
        ):
            r.histogram(
                "perf_model_error", {"phase": phase, "group": pool.gid},
                bounds=MODEL_ERROR_BUCKETS,
            ).observe(_rel_err(pb, mb_))
        r.counter("perf_predicted_bytes_total", {"phase": phase}).inc(
            pred.bytes_total
        )
        r.counter("perf_live_bytes_total", {"phase": phase}).inc(
            pred.live_bytes
        )
        st = self._phase(phase)
        st["launches"] += 1
        st["predicted_bytes"] += pred.bytes_total
        st["measured_bytes"] += measured_total
        st["live_bytes"] += pred.live_bytes
        st["full_walk_bytes"] += pred.full_bytes
        st["bucketed_bytes"] += pred.bucketed_bytes
        st["model_error_max"] = max(st["model_error_max"], err)
        self.launch_log.append(
            (phase, plans, n_rows,
             tuple(int(x) for x in np.asarray(eff_lengths).reshape(-1)))
        )
        return pred

    def summary(self) -> Dict[str, object]:
        """Per-phase attribution: predicted/measured/live/full bytes,
        exact max model error, roofline seconds at the device spec, and
        each phase's fraction of the total predicted HBM time."""
        bw = self.chip.hbm_bandwidth
        total_s = sum(
            st["measured_bytes"] / bw for st in self.phases.values()
        )
        out: Dict[str, object] = {"chip": self.chip.name, "phases": {}}
        for phase, st in sorted(self.phases.items()):
            meas = st["measured_bytes"]
            roofline_s = meas / bw
            out["phases"][phase] = {
                "launches": int(st["launches"]),
                "predicted_bytes": int(st["predicted_bytes"]),
                "measured_bytes": int(meas),
                "live_bytes": int(st["live_bytes"]),
                "full_walk_bytes": int(st["full_walk_bytes"]),
                "model_error_max": st["model_error_max"],
                "roofline_s": roofline_s,
                "roofline_fraction": (
                    roofline_s / total_s if total_s > 0 else 0.0
                ),
                # how much of what streams is live data (vs pow2 pad)
                "walk_efficiency": (
                    st["live_bytes"] / meas if meas > 0 else 1.0
                ),
                # what bucketing saved over the full-depth walk
                "bucketing_savings": (
                    1.0 - meas / st["full_walk_bytes"]
                    if st["full_walk_bytes"] > 0 else 0.0
                ),
            }
        out["model_error_max"] = max(
            (st["model_error_max"] for st in self.phases.values()),
            default=0.0,
        )
        out["roofline_total_s"] = total_s
        return out


class CompileWatcher:
    """Step-signature introspection for the serve steps.

    `serve.compiled.PagedStep` calls `on_compile` once per new (plans,
    argument signature) of a step — the reference's one XLA compile.
    Everything lands in the registry — `serve_recompiles_total{step,
    plans}`, `serve_compile_walltime_s{step}` — plus a host-side record
    list. The flop/byte gauges are 0: the port has no compiler cost
    analysis to read them from."""

    def __init__(self, registry: MetricsRegistry,
                 chip: ChipSpec = H100_SXM):
        self.registry = registry
        self.chip = chip
        self.compiles: List[Dict[str, object]] = []

    def clock(self) -> float:
        """The registry's injected clock, in seconds: `PagedStep` times a
        signature's first call through here, so a `ManualClock` registry
        makes the walltimes deterministic in tests."""
        return float(self.registry.clock())

    def on_compile(self, step: str, plans, walltime_s: float) -> None:
        sig = plan_signature(plans)
        r = self.registry
        r.counter(
            "serve_recompiles_total", {"step": step, "plans": sig}
        ).inc()
        r.histogram(
            "serve_compile_walltime_s", {"step": step},
            bounds=COMPILE_WALLTIME_BUCKETS,
        ).observe(walltime_s)
        flops, nbytes = 0.0, 0.0
        lab = {"step": step, "plans": sig}
        r.gauge("serve_compiled_hlo_flops", lab).set(flops)
        r.gauge("serve_compiled_hlo_bytes", lab).set(nbytes)
        self.compiles.append({
            "step": step,
            "plans": sig,
            "raw_plans": plans,
            "walltime_s": walltime_s,
            "hlo_flops": flops,
            "hlo_bytes": nbytes,
            "compute_s": flops / self.chip.peak_flops_bf16,
            "memory_s": nbytes / self.chip.hbm_bandwidth,
        })

    @property
    def total(self) -> int:
        return len(self.compiles)

    def by_step(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self.compiles:
            out[rec["step"]] = out.get(rec["step"], 0) + 1
        return out

    def summary(self) -> Dict[str, object]:
        return {
            "total": self.total,
            "by_step": self.by_step(),
            "distinct_plan_signatures": sorted(
                {(r["step"], r["plans"]) for r in self.compiles}
            ),
            "compiles": [
                {k: v for k, v in rec.items() if k != "raw_plans"}
                for rec in self.compiles
            ],
        }
