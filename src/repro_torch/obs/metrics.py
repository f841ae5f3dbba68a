"""Metrics primitives: counters, gauges, fixed-bucket histograms —
counterpart of `repro.obs.metrics`, a copy (standard library only).

The registry is the single mutable store the serving telemetry writes
into (DESIGN.md §13). Three design rules keep it fit for the decode hot
path and for deterministic tests:

  * **Injectable monotonic clock.** Every time-derived quantity (TTFT,
    TPOT, queue delay) reads `registry.clock()`, never `time.*`
    directly. Tests inject a `ManualClock` and the whole pipeline —
    histograms included — becomes bit-deterministic.
  * **Fixed buckets.** Histograms bucket at construction-time bounds, so
    two runs that observe the same values produce identical bucket
    counts and identical interpolated percentiles — no reservoir
    sampling, no adaptive resizing.
  * **Get-or-create lookup.** `registry.counter(name, labels)` returns
    the live metric; callers hold the object and mutate it directly
    (one attribute increment per event), so the steady-state cost of a
    counter bump is an int add, not a dict walk.

Naming conventions (enforced only by discipline, documented in
DESIGN.md §13): `serve_*` request/lifecycle metrics, `pool_*` KV-pool
and prefix-index state, `kernel_*` launch/streamed-byte accounting.

The module-level `mutation_count()` exists for one purpose: proving the
metrics-OFF path makes zero registry calls (every `inc`/`set`/`observe`
bumps it, so a drain that leaves it unchanged touched no metric).
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LabelSet = Tuple[Tuple[str, str], ...]

#: total inc/set/observe calls process-wide — the metrics-off tests
#: assert this does not move during an uninstrumented drain
_MUTATIONS = 0


def mutation_count() -> int:
    return _MUTATIONS


def _bump() -> None:
    global _MUTATIONS
    _MUTATIONS += 1


#: default latency buckets (seconds): 100 us .. ~2 min, x2 per step —
#: wide enough for CPU smoke runs and serving on the card alike
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    1e-4 * 2.0 ** i for i in range(21)
)


def exponential_buckets(start: float, factor: float, count: int
                        ) -> Tuple[float, ...]:
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError((start, factor, count))
    return tuple(start * factor ** i for i in range(count))


class ManualClock:
    """Deterministic injectable clock. `tick` > 0 advances the reading
    by that much on every call (so repeated reads are distinct but
    reproducible); `advance` models explicit elapsed time."""

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        self.now = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        t = self.now
        self.now += self.tick
        return t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock cannot go backwards (dt={dt})")
        self.now += dt


def _labels(labels: Optional[Dict[str, object]]) -> LabelSet:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render(name: str, labels: LabelSet) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


def _escape_label_value(v: str) -> str:
    """Prometheus exposition-format label-value escaping: backslash,
    double-quote, and newline must be escaped or the scrape line is
    unparseable (a plan signature or model name containing `"` would
    otherwise corrupt the whole snapshot)."""
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _render_prom(name: str, labels: LabelSet) -> str:
    """Like `_render` but with exposition-format escaping; label order
    is deterministic because `_labels` sorts label keys."""
    if not labels:
        return name
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in labels
    )
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone accumulator."""

    __slots__ = ("name", "labels", "value")

    kind = "counter"

    def __init__(self, name: str, labels: LabelSet = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        _bump()
        self.value += n

    def state(self) -> Dict[str, object]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-value metric; tracks the min/max ever set, so per-tick
    samples carry their own peak/floor (the benches' "peak resident
    bytes" and CI's "never negative" both read straight off this)."""

    __slots__ = ("name", "labels", "value", "min", "max")

    kind = "gauge"

    def __init__(self, name: str, labels: LabelSet = ()):
        self.name = name
        self.labels = labels
        self.value: Optional[float] = None
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def set(self, v) -> None:
        _bump()
        self.value = v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def state(self) -> Dict[str, object]:
        return {"type": "gauge", "value": self.value, "min": self.min,
                "max": self.max}


class Histogram:
    """Fixed-bucket histogram with deterministic interpolated quantiles.

    `bounds` are inclusive upper edges of the finite buckets; one
    overflow bucket is implicit. `percentile(q)` linearly interpolates
    inside the bucket holding the q-th rank (overflow values clamp to
    the last finite bound) — with fixed bounds and identical
    observations the result is bit-reproducible.
    """

    __slots__ = ("name", "labels", "bounds", "counts", "sum", "count")

    kind = "histogram"

    def __init__(self, name: str, labels: LabelSet = (),
                 bounds: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"histogram {name}: bad bounds {bounds}")
        self.name = name
        self.labels = labels
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        _bump()
        # bucket i spans (bounds[i-1], bounds[i]] — upper edges are
        # INCLUSIVE, so a value exactly equal to the top finite edge
        # lands in the last finite bucket, never in overflow
        # (bisect_left returns the index of the first bound >= v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100]; None when empty."""
        if self.count == 0:
            return None
        rank = q / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else \
                    self.bounds[-1]
                frac = (rank - seen) / c if c else 0.0
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.bounds[-1]

    def state(self) -> Dict[str, object]:
        return {
            "type": "histogram", "count": self.count, "sum": self.sum,
            "p50": self.percentile(50), "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Get-or-create store of named metrics + the injected clock.

    One registry per serving run; exporters are `summary()` (plain
    dict, JSON-able), `prometheus()` (text exposition snapshot), and
    whatever the caller does with the live metric objects.
    """

    def __init__(self, clock=None):
        self.clock = clock if clock is not None else time.monotonic
        self._metrics: Dict[Tuple[str, LabelSet], object] = {}
        self._help: Dict[str, str] = {}

    def _get(self, cls, name: str, labels, help=None, **kw):
        key = (name, _labels(labels))
        if help is not None and name not in self._help:
            self._help[name] = str(help)
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, key[1], **kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name} already registered as {type(m).__name__}"
            )
        return m

    def counter(self, name: str, labels=None, help=None) -> Counter:
        return self._get(Counter, name, labels, help=help)

    def gauge(self, name: str, labels=None, help=None) -> Gauge:
        return self._get(Gauge, name, labels, help=help)

    def histogram(self, name: str, labels=None,
                  bounds: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  help=None) -> Histogram:
        h = self._get(Histogram, name, labels, help=help, bounds=bounds)
        if h.bounds != tuple(float(b) for b in bounds):
            raise ValueError(
                f"histogram {name}: conflicting bucket bounds"
            )
        return h

    def __iter__(self) -> Iterable:
        return iter(self._metrics.values())

    def find(self, name: str) -> List[object]:
        """All metrics with this base name (any label set)."""
        return [m for (n, _), m in self._metrics.items() if n == name]

    # -- exporters ---------------------------------------------------------

    def summary(self) -> Dict[str, Dict[str, object]]:
        """{rendered_name: state} — the run-summary dict exporter."""
        return {
            _render(name, labels): m.state()
            for (name, labels), m in sorted(self._metrics.items())
        }

    def prometheus(self) -> str:
        """Prometheus-style text exposition snapshot.

        Format contract (pinned by the golden-file test in
        `tests/test_obs.py`): metrics sort by (name, sorted label set)
        so output is deterministic; each metric family gets one
        `# HELP` line (when help text was registered) then one
        `# TYPE` line before its first sample; label values are
        exposition-escaped (`\\`, `"`, newline).
        """
        lines: List[str] = []
        seen_type = set()
        for (name, labels), m in sorted(self._metrics.items()):
            if name not in seen_type:
                if name in self._help:
                    help_text = self._help[name].replace(
                        "\\", r"\\").replace("\n", r"\n")
                    lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} {m.kind}")
                seen_type.add(name)
            full = _render_prom(name, labels)
            if isinstance(m, Histogram):
                cum = 0
                for b, c in zip(m.bounds, m.counts):
                    cum += c
                    le = _labels(dict(labels) | {"le": f"{b:g}"})
                    lines.append(
                        f"{_render_prom(name + '_bucket', le)} {cum}"
                    )
                le = _labels(dict(labels) | {"le": "+Inf"})
                lines.append(
                    f"{_render_prom(name + '_bucket', le)} {m.count}"
                )
                lines.append(
                    f"{_render_prom(name + '_sum', labels)} {m.sum:g}"
                )
                lines.append(
                    f"{_render_prom(name + '_count', labels)} {m.count}"
                )
            else:
                v = m.value if m.value is not None else 0
                lines.append(f"{full} {v:g}")
        return "\n".join(lines) + ("\n" if lines else "")
