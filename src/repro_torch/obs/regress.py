"""Bench-history records and the perf regression gate: counterpart of
`repro.obs.regress` (DESIGN.md §14), framework-free, kept as a copy so
the port imports nothing of the reference.

`results/*.json` are snapshots — every bench run overwrites them, so
the history and the gate are what remember a performance trajectory:

  * **History**: `make_record()` normalizes one bench run into a flat
    record — git sha, UTC timestamp, a config hash over the headline
    metric set, and the headline scalars themselves — and
    `append_history()` appends it to `results/history.jsonl`
    (append-only; one line per run).
  * **Gate**: `compare()` diffs the current headline metrics against a
    pinned baseline (`benchmarks/baselines.json`'s schema) under
    per-metric tolerance bands and returns the violations.

Only machine-independent *structural* quantities are gated: streamed
bytes, token and tick counts, page counts, model-error stats. Wall
times and tok/s go into the history record (trend data) but never into
the gate — host walls are too noisy for walltime tolerance bands to
mean anything.

Tolerance bands are direction-aware. `high_bad` (bytes, errors,
fractions of waste): only an increase beyond the band is a regression
— improvements never fail the gate, they are the signal to re-pin.
`low_bad` (savings, reductions): only a decrease. `exact` (token
parity, page counts, plan-derived byte totals): any difference — these
are deterministic by construction, so drift means a behavior change
someone must either fix or re-pin deliberately.

`HEADLINE_SPECS`, `TREND_SPECS` and the tolerance semantics are the
reference's, key for key, so one baselines file reads the same under
either package. The port's analysis CLI writes its findings to
`analysis_findings_torch.json`; a results directory holding it under
the reference's name `analysis_findings.json` gates the same way.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
from datetime import datetime, timezone
from typing import Dict, List, Optional, Tuple

SCHEMA_VERSION = 1

#: headline metric spec: (metric key, results file, dot-path in the
#: file's JSON, direction, rel_tol, abs_tol). Direction semantics are
#: documented in the module docstring; tolerance allowed deviation is
#: max(rel_tol * |baseline|, abs_tol).
HEADLINE_SPECS: Tuple[Tuple[str, str, str, str, float, float], ...] = (
    # serving trace — token parity and structural byte accounting
    ("serve.paged.decode_tokens", "serve_bench.json",
     "paged.decode_tokens", "exact", 0.0, 0.0),
    ("serve.paged.prefill_tokens", "serve_bench.json",
     "paged.prefill_tokens", "exact", 0.0, 0.0),
    ("serve.paged.ticks", "serve_bench.json",
     "paged.ticks", "exact", 0.0, 0.0),
    ("serve.paged.streamed_bytes_total", "serve_bench.json",
     "paged.streamed_bytes_total", "high_bad", 0.01, 0.0),
    ("serve.dense.decode_tokens", "serve_bench.json",
     "dense.decode_tokens", "exact", 0.0, 0.0),
    ("serve.prefill_padding_waste", "serve_bench.json",
     "prefill_padding_waste", "high_bad", 0.0, 0.05),
    ("serve.perf.model_error_max", "serve_bench.json",
     "paged.perf.model_error_max", "high_bad", 0.0, 0.01),
    ("serve.recompiles_total", "serve_bench.json",
     "paged.recompiles.total", "exact", 0.0, 0.0),
    # paged kernel raggedness sweep — plan-derived page counts are
    # exact; fractions get a small absolute band
    ("kernel.geometric.kv_pages_streamed", "paged_kernel_bench.json",
     "bucketed.profiles.geometric.kv_pages_streamed", "exact", 0.0, 0.0),
    ("kernel.geometric.streamed_fraction", "paged_kernel_bench.json",
     "bucketed.profiles.geometric.streamed_fraction",
     "high_bad", 0.0, 0.01),
    ("kernel.mixed.kv_pages_streamed", "paged_kernel_bench.json",
     "bucketed.profiles.mixed.kv_pages_streamed", "exact", 0.0, 0.0),
    ("kernel.gather_reduction", "paged_kernel_bench.json",
     "gather_reduction", "low_bad", 0.0, 0.01),
    ("kernel.windowed.streamed_fraction", "paged_kernel_bench.json",
     "windowed.streamed_fraction", "high_bad", 0.0, 0.01),
    ("kernel.model_error_max", "paged_kernel_bench.json",
     "bucketed.model_error_max", "high_bad", 0.0, 0.01),
    # quantized int8 KV pages (DESIGN.md §16) — per-page byte ratio vs
    # bf16 (plan-derived, so the bench asserts <= 0.55 and the gate
    # holds it near the pin), the pinned int8 tolerance vs the fp
    # oracle, and the serve-trace drain's structural byte ratio
    ("paged.kv.resident_bytes_ratio", "paged_kernel_bench.json",
     "quantized.resident_bytes_ratio", "high_bad", 0.0, 0.01),
    ("paged.kv.int8_max_abs_error", "paged_kernel_bench.json",
     "quantized.max_abs_err_vs_fp_oracle", "high_bad", 0.0, 0.03),
    ("kernel.windowed.int8_bytes_ratio", "paged_kernel_bench.json",
     "windowed.int8_streamed_bytes_ratio", "high_bad", 0.0, 0.01),
    ("serve.paged_int8.streamed_bytes_ratio", "serve_bench.json",
     "paged_int8.streamed_bytes_ratio", "high_bad", 0.0, 0.01),
    ("serve.paged_int8.model_error_max", "serve_bench.json",
     "paged_int8.perf.model_error_max", "high_bad", 0.0, 0.01),
    # long-context trio (DESIGN.md §17) — chunked prefill + per-group
    # sizing must keep shrinking the windowed stack's peak resident and
    # provisioned page bytes (structural ratios, exact at a fixed
    # trace), stay bit-exact vs single-shot, hold the §14 gate at zero
    # on per-chunk accounting, and keep the chunk retrace set bounded
    ("serve.long_prompt.peak_resident_ratio", "serve_bench.json",
     "long_prompt.peak_resident_ratio", "high_bad", 0.0, 0.01),
    ("serve.long_prompt.provisioned_ratio", "serve_bench.json",
     "long_prompt.provisioned_ratio", "high_bad", 0.0, 0.01),
    ("serve.long_prompt.tokens_bit_exact", "serve_bench.json",
     "long_prompt.tokens_bit_exact", "exact", 0.0, 0.0),
    ("serve.long_prompt.model_error_max", "serve_bench.json",
     "long_prompt.chunked_auto_sized.perf.model_error_max",
     "high_bad", 0.0, 0.01),
    ("serve.long_prompt.recompiles", "serve_bench.json",
     "long_prompt.chunked_auto_sized.recompiles", "exact", 0.0, 0.0),
    ("serve.long_prompt.ticks", "serve_bench.json",
     "long_prompt.chunked_auto_sized.ticks", "exact", 0.0, 0.0),
    # prefix sharing — dedup structure and token parity
    ("prefix.tokens_bit_exact", "prefix_bench.json",
     "tokens_bit_exact", "exact", 0.0, 0.0),
    ("prefix.prefill_token_reduction", "prefix_bench.json",
     "prefill_token_reduction", "low_bad", 0.0, 0.02),
    ("prefix.shared.streamed_bytes_total", "prefix_bench.json",
     "shared.streamed_bytes_total", "high_bad", 0.01, 0.0),
    ("prefix.shared.pages_allocated", "prefix_bench.json",
     "shared.pages_allocated", "exact", 0.0, 0.0),
    # static-analysis ratchet (DESIGN.md §15) — findings may only
    # shrink. NEW findings already fail `python -m repro_torch.analysis
    # --gate`; pinning the totals here makes the count visible in
    # history.jsonl and turns silent baseline growth into a perf
    # regression too.
    ("analysis.findings_total", "analysis_findings.json",
     "counts.total", "high_bad", 0.0, 0.0),
    ("analysis.findings_new", "analysis_findings.json",
     "counts.new", "high_bad", 0.0, 0.0),
)

#: ungated trend-only scalars recorded in history (walltime noise)
TREND_SPECS: Tuple[Tuple[str, str, str], ...] = (
    ("serve.paged.tok_per_s", "serve_bench.json", "paged.tok_per_s"),
    ("serve.dense.tok_per_s", "serve_bench.json", "dense.tok_per_s"),
    ("serve.paged.wall_s", "serve_bench.json", "paged.wall_s"),
)


def git_sha(repo_dir: Optional[str] = None) -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=repo_dir,
            capture_output=True, text=True, timeout=10,
        )
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except Exception:
        return None


def utc_now_iso() -> str:
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def config_hash(obj) -> str:
    """12-hex digest of the canonical JSON form — two runs with the
    same gated configuration hash identically, so history lines are
    comparable at a glance."""
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _dig(obj, dotted: str):
    cur = obj
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def _as_scalar(v) -> Optional[float]:
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, float)):
        return float(v)
    return None


def collect_headline(results_dir: str) -> Dict[str, float]:
    """Flatten the gated headline scalars out of `results/*.json`.
    Missing files or paths are skipped (the gate reports them as
    missing metrics when the baseline expects them)."""
    cache: Dict[str, Optional[dict]] = {}
    out: Dict[str, float] = {}
    for key, fname, path, _dir, _rt, _at in HEADLINE_SPECS:
        if fname not in cache:
            p = os.path.join(results_dir, fname)
            try:
                with open(p) as fh:
                    cache[fname] = json.load(fh)
            except (OSError, json.JSONDecodeError):
                cache[fname] = None
        blob = cache[fname]
        if blob is None:
            continue
        v = _as_scalar(_dig(blob, path))
        if v is not None:
            out[key] = v
    return out


def collect_trend(results_dir: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for key, fname, path in TREND_SPECS:
        p = os.path.join(results_dir, fname)
        try:
            with open(p) as fh:
                blob = json.load(fh)
        except (OSError, json.JSONDecodeError):
            continue
        v = _as_scalar(_dig(blob, path))
        if v is not None:
            out[key] = v
    return out


def tolerance_spec() -> Dict[str, Dict[str, float]]:
    """{metric: {direction, rel_tol, abs_tol}} for the gated set."""
    return {
        key: {"direction": d, "rel_tol": rt, "abs_tol": at}
        for key, _f, _p, d, rt, at in HEADLINE_SPECS
    }


def make_record(results_dir: str,
                extra: Optional[Dict[str, object]] = None
                ) -> Dict[str, object]:
    """One normalized history line for the current run."""
    metrics = collect_headline(results_dir)
    rec: Dict[str, object] = {
        "schema": SCHEMA_VERSION,
        "ts_utc": utc_now_iso(),
        "git_sha": git_sha(),
        "config_hash": config_hash(sorted(metrics.keys())),
        "metrics": metrics,
        "trend": collect_trend(results_dir),
    }
    if extra:
        rec.update(extra)
    return rec


def append_history(history_path: str, record: Dict[str, object]) -> None:
    os.makedirs(os.path.dirname(history_path) or ".", exist_ok=True)
    with open(history_path, "a") as fh:
        fh.write(json.dumps(record, sort_keys=True) + "\n")


def read_history(history_path: str) -> List[Dict[str, object]]:
    if not os.path.exists(history_path):
        return []
    out = []
    with open(history_path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


@dataclasses.dataclass
class Violation:
    metric: str
    baseline: Optional[float]
    current: Optional[float]
    direction: str
    allowed: float
    reason: str

    def __str__(self) -> str:
        return (f"{self.metric}: baseline={self.baseline} "
                f"current={self.current} ({self.reason}, "
                f"direction={self.direction}, allowed=±{self.allowed:g})")


def _allowed(base: float, spec: Dict[str, float]) -> float:
    return max(spec.get("rel_tol", 0.0) * abs(base),
               spec.get("abs_tol", 0.0))


def compare(current: Dict[str, float],
            baseline_metrics: Dict[str, float],
            tolerances: Optional[Dict[str, Dict[str, float]]] = None,
            ) -> Tuple[List[Violation], List[str]]:
    """Diff current headline metrics against the pinned baseline.

    Returns (violations, notes). Every baseline metric must be present
    in the current run (a bench that silently stopped reporting a
    gated number is itself a regression); new current-only metrics are
    notes, not failures, until they are pinned.
    """
    tol = tolerances if tolerances is not None else tolerance_spec()
    violations: List[Violation] = []
    notes: List[str] = []
    for metric, base in sorted(baseline_metrics.items()):
        spec = tol.get(metric, {"direction": "high_bad",
                                "rel_tol": 0.05, "abs_tol": 0.0})
        direction = spec.get("direction", "high_bad")
        cur = current.get(metric)
        if cur is None:
            violations.append(Violation(
                metric, base, None, direction, 0.0,
                "metric missing from current run"))
            continue
        allow = _allowed(base, spec)
        if direction == "exact":
            bad = cur != base
            reason = "exact-match metric changed"
        elif direction == "high_bad":
            bad = cur > base + allow
            reason = "increased beyond tolerance band"
        elif direction == "low_bad":
            bad = cur < base - allow
            reason = "decreased beyond tolerance band"
        else:  # "both"
            bad = abs(cur - base) > allow
            reason = "moved beyond tolerance band"
        if bad:
            violations.append(Violation(
                metric, base, cur, direction, allow, reason))
        elif direction != "exact" and cur != base:
            notes.append(
                f"{metric}: {base} -> {cur} (within band)")
    for metric in sorted(set(current) - set(baseline_metrics)):
        notes.append(f"{metric}: new metric (not in baseline) — "
                     f"value {current[metric]}")
    return violations, notes


def pin_baselines(path: str, results_dir: str) -> Dict[str, object]:
    """Write `baselines.json` from the current results — the deliberate
    re-pin action after an accepted perf change."""
    metrics = collect_headline(results_dir)
    blob = {
        "schema": SCHEMA_VERSION,
        "pinned_at": utc_now_iso(),
        "git_sha": git_sha(),
        "tolerances": tolerance_spec(),
        "metrics": metrics,
    }
    with open(path, "w") as fh:
        json.dump(blob, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return blob


def load_baselines(path: str) -> Dict[str, object]:
    with open(path) as fh:
        return json.load(fh)
