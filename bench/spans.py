"""The program's own spans and KV pool gauges, and the reductions the
span readers (`bench/metrics/decode_dispatch_ms.py`,
`host_syncs_per_tick.py`, `idle_in_dispatch_pct.py`,
`idle_in_scheduler_pct.py`, `kv_reserved_unused_pct.py`) share.

They read what a traced run would keep with the program's telemetry
(`ServeTelemetry`, profile off) on its batcher: on each `Tick`,
`program`, what `Probe.after` returned for its step; on the `Record`,
`spans` (`collect`) and `idle_split` (`stretch_split`). `Probe` notes the
program's span count around each `step()` and its pool gauges after it,
so each harness tick is matched to the spans its own step opened by
their sequence numbers, never by the clock, and the warm ticks' spans
stay apart from the window's. The harness does not attach the telemetry
yet (`system.build` makes the batcher without it), so on today's records
every reader here finds nothing; PERF.md §7 lists the edits that attach
it.

The program stamps its spans on `time.time_ns`, the domain the profiler
reports host ranges and device activities in. `idle_split` cuts the
stretch's device-idle time by the innermost program span open at each
idle instant: the harness loop (no `serve/tick` open), the host syncs,
the model's dispatch and the scheduler. The four terms sum to the
stretch's idle share (`reduce.idle_pct`).

A program that records no spans (no `span_records` on its telemetry)
leaves the same nothing to read.
"""

from __future__ import annotations

import bisect
import sys
from typing import Dict, List, Optional, Tuple

from . import trace

TICK = "serve/tick"
#: the host waiting for the card: the decode's tokens, a prefill's argmax
SYNCS = ("serve/sync", "serve/first_token")
#: the step calls: the model's layers enqueued, launch by launch
DISPATCH = ("serve/paged_decode", "serve/paged_prefill",
            "serve/dense_decode", "serve/dense_prefill")
#: the scheduler's own host work, the tick's root included
SCHEDULER = ("serve/admit", "serve/decode_prep", "serve/retire", TICK)
#: the idle split's terms, in the order they are printed
TERMS = ("sync", "harness", "dispatch", "scheduler")
_TERM_OF = {**{n: "sync" for n in SYNCS},
            **{n: "dispatch" for n in DISPATCH},
            **{n: "scheduler" for n in SCHEDULER}}
_POOL_GAUGES = ("pool_free_pages", "pool_unreserved_pages",
                "pool_allocated_pages")


class Probe:
    """Told before and after each step of the loop (`loop.drive`'s
    `probe`); `after` returns `(first seq, end seq, pool)`: the seq range
    of the spans the step opened, and the pages free, unreserved and
    allocated over every layer group as the step's end-of-tick sample
    set them (None before the program has set them)."""

    def __init__(self, telemetry):
        self.tel = telemetry
        self._n0 = 0
        self._gauges = None

    def before(self):
        self._n0 = self.tel.span_count

    def after(self):
        return (self._n0, self.tel.span_count, self._pool())

    def _pool(self):
        if self._gauges is None:
            found = [self.tel.registry.find(n) for n in _POOL_GAUGES]
            if not all(found):
                return None
            self._gauges = found
        return tuple(sum(g.value for g in gs) for gs in self._gauges)


def collect(telemetry, ticks) -> Tuple[Dict[int, object], int]:
    """The spans of the probed `ticks` by seq, and how many of them the
    program's ring no longer held."""
    marks = [m for m in (getattr(t, "program", None) for t in ticks)
             if m is not None]
    if not marks:
        return {}, 0
    held = {r.seq: r for r in telemetry.span_records(marks[0][0])}
    out = {seq: held[seq] for a, b, _ in marks for seq in range(a, b)
           if seq in held}
    return out, sum(b - a for a, b, _ in marks) - len(out)


def tick_spans(record, tick) -> Optional[list]:
    """The spans `tick`'s step opened, in seq order; None where the tick
    was not probed or one of its spans is missing."""
    mark = getattr(tick, "program", None)
    if mark is None:
        return None
    a, b, _ = mark
    held = getattr(record, "spans", {})
    out = [held.get(seq) for seq in range(a, b)]
    return None if not out or None in out else out


def matched(spans) -> bool:
    """The step opened exactly one root, a `serve/tick`, and every other
    span it opened lies under that root."""
    root = spans[0]
    return (root.name == TICK and root.parent == -1
            and all(root.seq <= s.parent < s.seq for s in spans[1:]))


def window_spans(record, decode_only: bool = False) -> List[list]:
    """Per window tick whose step opened one `serve/tick` root: its
    spans. `decode_only`: the ticks that decoded and prefilled nothing."""
    out = []
    for t in record.window_ticks():
        if decode_only and (not t.decoded or t.first):
            continue
        sp = tick_spans(record, t)
        if sp is not None and matched(sp):
            out.append(sp)
    return out


def _pool(tick) -> Optional[tuple]:
    mark = getattr(tick, "program", None)
    return None if mark is None else mark[2]


def window_pool(record) -> List[tuple]:
    """(free, unreserved, allocated) pages after each window tick."""
    return [p for p in map(_pool, record.window_ticks()) if p is not None]


def pages_peak(record) -> Optional[int]:
    """The most pages allocated after the window's opening tick or any of
    its ticks, by the program's gauges: what `run._Window` reads from the
    pools themselves."""
    vals = [_pool(t) for t in record.ticks
            if record.t_open <= t.t1 <= record.t_close]
    vals = [p[2] for p in vals if p is not None]
    return max(vals) if vals else None


# ---------------------------------------------------------------------------
# the device's idle time by host phase
# ---------------------------------------------------------------------------

def segments(spans) -> List[Tuple[float, float, str]]:
    """Disjoint `(start_s, end_s, name)` pieces of the nested `spans`,
    each labelled with the innermost span open over it."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []
    cursor = 0.0
    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns, s.seq)):
        a, b = s.start_ns * 1e-9, s.end_ns * 1e-9
        while stack and stack[-1][0] <= a:
            end, name = stack.pop()
            out.append((cursor, end, name))
            cursor = end
        if stack:
            out.append((cursor, a, stack[-1][1]))
        stack.append((b, s.name))
        cursor = a
    while stack:
        end, name = stack.pop()
        out.append((cursor, end, name))
        cursor = end
    return [p for p in out if p[1] > p[0]]


def _overlap_by_label(gaps, pieces) -> Dict[str, float]:
    """Seconds of the sorted disjoint `gaps` under each label of the
    sorted disjoint `pieces`."""
    out: Dict[str, float] = {}
    j = 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                out[pieces[k][2]] = out.get(pieces[k][2], 0.0) + hi - lo
            k += 1
    return out


def profiled(events) -> Tuple[Tuple[float, float], list, list]:
    """From the profiler's raw events, read as `trace.reduce_events`
    reads them: the stretch `(start_s, end_s)`, the device activities'
    intervals and the host times of the calls that launched them."""
    stretch, kernels, launch_at, device_corr = None, [], {}, set()
    if events and all(hasattr(events[0], m)
                      for m in ("activity_type", "start_ns")):
        # the events say their kind: read only what the split needs (a
        # stretch holds ~10^6 events, most of them host ops)
        for e in events:
            kind = e.activity_type()
            if kind in trace._DEVICE:
                a = e.start_ns()
                kernels.append((a * 1e-9, (a + e.duration_ns()) * 1e-9))
                device_corr.add(e.correlation_id())
            elif kind in trace._LAUNCHERS:
                launch_at[e.correlation_id()] = e.start_ns() * 1e-9
            elif kind == "user_annotation" and e.name() == trace.STRETCH:
                a = e.start_ns()
                stretch = (a * 1e-9, (a + e.duration_ns()) * 1e-9)
    else:
        for kind, name, a, b, corr, _ in trace._classify(events):
            if kind == "device":
                kernels.append((a, b))
                device_corr.add(corr)
            elif kind == "launch":
                launch_at[corr] = a
            elif name == trace.STRETCH:
                stretch = (a, b)
    if stretch is None:
        stretch = (min((k[0] for k in kernels), default=0.0),
                   max((k[1] for k in kernels), default=0.0))
    launches = sorted(t for c, t in launch_at.items() if c in device_corr)
    return stretch, kernels, launches


def idle_split(stretch, kernels, launches, spans) -> Optional[dict]:
    """The stretch's idle share and its four terms, in % of the stretch:
    `sync`, `harness` (no `serve/tick` open), `dispatch`, `scheduler`;
    `other` for a span name outside the three lists (none today). Also
    the launches of device work in the stretch and how many of them a
    `serve/tick` span holds."""
    a0, b0 = stretch
    window = b0 - a0
    if window <= 0:
        return None
    busy = trace._merge([[max(a, a0), min(b, b0)] for a, b in kernels
                         if b > a0 and a < b0])
    edges = [a0] + [x for iv in busy for x in iv] + [b0]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle = sum(b - a for a, b in gaps)
    by_name = _overlap_by_label(gaps, segments(spans))
    split = dict.fromkeys(TERMS + ("other",), 0.0)
    for name, s in by_name.items():
        split[_TERM_OF.get(name, "other")] += s
    split["harness"] = idle - sum(by_name.values())
    out = {k: 100.0 * v / window for k, v in split.items()}
    out["idle"] = 100.0 * idle / window
    ticks = sorted((s.start_ns * 1e-9, s.end_ns * 1e-9) for s in spans
                   if s.name == TICK)
    starts = [a for a, _ in ticks]
    inside = 0
    stretch_launches = [t for t in launches if a0 <= t <= b0]
    for t in stretch_launches:
        i = bisect.bisect_right(starts, t) - 1
        inside += i >= 0 and t <= ticks[i][1]
    out["launches"] = len(stretch_launches)
    out["launches_in_tick"] = inside
    return out


def stretch_split(tracer, record) -> Optional[dict]:
    """`idle_split` of the traced stretch, from the profiler `tracer` ran
    (`trace.Tracer`) and the spans of the stretch's ticks."""
    prof = tracer._prof
    if prof is None:
        return None
    spans = [s for t in record.stretch_ticks()
             for s in (tick_spans(record, t) or ())]
    if not spans:
        return None
    return idle_split(*profiled(prof.profiler.kineto_results.events()),
                      spans)


def report(record, lost: int, harness_pages_peak: int, idle_pct) -> None:
    """The traced run's checks of the spans, on standard error."""
    probed = [t for t in record.window_ticks()
              if getattr(t, "program", None) is not None]
    ticks = window_spans(record)
    print(f"[spans] {len(probed)} window ticks probed, {len(ticks)} "
          f"matched to one serve/tick span each; {lost} spans lost from "
          f"the ring", file=sys.stderr)
    if ticks:
        total: Dict[str, int] = {}
        for sp in ticks:
            for s in sp:
                total[s.name] = total.get(s.name, 0) + s.end_ns - s.start_ns
        n = sum(len(sp) for sp in ticks) / len(ticks)
        means = ", ".join(f"{k} {1e-6 * v / len(ticks)}"
                          for k, v in sorted(total.items()))
        print(f"[spans] window, per tick: {n} spans; ms: {means}",
              file=sys.stderr)
    print(f"[spans] pool gauges: peak {pages_peak(record)} pages allocated "
          f"in the window (harness {harness_pages_peak})", file=sys.stderr)
    s = getattr(record, "idle_split", None)
    if s is None:
        return
    share = (100.0 * s["launches_in_tick"] / s["launches"]
             if s["launches"] else None)
    print(f"[spans] stretch: {s['launches_in_tick']} of {s['launches']} "
          f"device launches inside a serve/tick span ({share} %)",
          file=sys.stderr)
    terms = " + ".join(f"{k} {s[k]}" for k in TERMS)
    print(f"[spans] idle {s['idle']} % = {terms} (other {s['other']}); "
          f"device_idle_pct {idle_pct}", file=sys.stderr)
