"""The traced stretch: `torch.profiler` over a few dozen ticks after the
window, reduced in memory to what the per-layer readers need.

Each device activity (kernel, copy, set) is tied to the host call that
launched it by their shared correlation id, and so to every host range
open at that moment: the benchmark's own ranges around the kernel entry
points (`bench/k1` ..., see `system.Ranges`) and the prefill step
(`bench/prefill`, `system.watch_batcher`), and `bench/stretch`, which
spans the stretch. Device seconds are the profiler's; the busy time is
the union of the device intervals.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch

STRETCH = "bench/stretch"
#: host events that launch device work (CUDA runtime and driver calls)
_LAUNCH = re.compile(r"^cu(da)?[A-Z]")
_RANGE_PREFIXES = ("bench/",)


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]            # name, start, end (s)
    ranges: Dict[str, List[List[int]]]                  # name -> per call, kernel ids
    unattributed: int
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    def device_s(self, name: str) -> Optional[float]:
        """Device seconds of every kernel launched inside a range `name`;
        None when no such range launched anything."""
        ids = {k for call in self.ranges.get(name, ()) for k in call}
        if not ids:
            return None
        return sum(self.kernels[k][2] - self.kernels[k][1] for k in ids)

    def spans_s(self, name: str) -> List[float]:
        """Per call of range `name`: from its first kernel's start to its
        last kernel's end."""
        out = []
        for call in self.ranges.get(name, ()):
            if call:
                out.append(max(self.kernels[k][2] for k in call)
                           - min(self.kernels[k][1] for k in call))
        return out


class Tracer:
    """Starts and stops the profiler around the stretch."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity
        self.device = device
        self.activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            self.activities.append(ProfilerActivity.CUDA)
        self._prof = None
        self._range = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._prof = torch.profiler.profile(activities=self.activities)
        self._prof.__enter__()
        self._range = torch.profiler.record_function(STRETCH)
        self._range.__enter__()

    def stop(self):
        self._sync()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def reduce(self) -> Optional[Trace]:
        if self._prof is None:
            return None
        return reduce_events(self._prof.profiler.kineto_results.events())


#: activity kinds of the profiler's events, where the event says its kind
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCHERS = ("cuda_runtime", "cuda_driver")


def _classify(events):
    """Yield `(kind, name, start_s, end_s, correlation, thread)` with kind
    "device", "launch" or "host". Where the profiler's events do not say
    their kind (older PyTorch), the device type and the name tell it:
    device events are the card's, runtime and driver calls are named
    `cuda*` / `cu*`, and the card's mirror of a host range carries that
    range's name and is dropped."""
    if not events:
        return
    e0 = events[0]
    if hasattr(e0, "start_ns"):
        def times(e):
            return e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9
    else:
        def times(e):
            return e.start_us() * 1e-6, (e.start_us() + e.duration_us()) * 1e-6
    cpu = torch.autograd.DeviceType.CPU
    if hasattr(e0, "activity_type"):
        for e in events:
            kind = e.activity_type()
            if kind in _DEVICE:
                yield ("device", e.name(), *times(e), e.correlation_id(), 0)
            elif kind in _LAUNCHERS:
                yield ("launch", e.name(), *times(e), e.correlation_id(), 0)
            elif kind in ("cpu_op", "user_annotation"):
                yield ("host", e.name(), *times(e), 0, e.start_thread_id())
        return
    host_names = {e.name() for e in events if e.device_type() == cpu}
    for e in events:
        name = e.name()
        if e.device_type() != cpu:
            if name not in host_names:
                yield ("device", name, *times(e), e.correlation_id(), 0)
        elif _LAUNCH.match(name):
            yield ("launch", name, *times(e), e.correlation_id(), 0)
        else:
            yield ("host", name, *times(e), 0, e.start_thread_id())


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events) -> Trace:
    """`events`: the profiler's raw event list
    (`prof.profiler.kineto_results.events()`)."""
    host, kernels, launch_at, dev_corr = [], [], {}, []
    for kind, name, a, b, corr, thread in _classify(events):
        if kind == "device":
            kernels.append((name, a, b))
            dev_corr.append(corr)
        elif kind == "launch":
            launch_at[corr] = a
        else:
            host.append((a, b, name, thread))
    launched, unattributed = [], 0
    for k, corr in enumerate(dev_corr):
        t = launch_at.get(corr)
        if t is None:
            unattributed += 1
        else:
            launched.append((t, k))
    launched.sort()
    times = [t for t, _ in launched]
    ranges: Dict[str, List[List[int]]] = {}
    stretch = None
    for a, b, name, _ in host:
        if not name.startswith(_RANGE_PREFIXES):
            continue
        i, j = bisect.bisect_left(times, a), bisect.bisect_right(times, b)
        ranges.setdefault(name, []).append([k for _, k in launched[i:j]])
        if name == STRETCH:
            stretch = (a, b)
    if stretch is None:
        stretch = (min((k[1] for k in kernels), default=0.0),
                   max((k[2] for k in kernels), default=0.0))
    busy = _merge([[max(k[1], stretch[0]), min(k[2], stretch[1])]
                   for k in kernels
                   if k[2] > stretch[0] and k[1] < stretch[1]])
    busy_s = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    for name, a, b in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    edges = [stretch[0]] + [x for iv in busy for x in iv] + [stretch[1]]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    return Trace(window_s=stretch[1] - stretch[0], busy_s=busy_s,
                 kernels=kernels, ranges=ranges, unattributed=unattributed,
                 device_ops=[(n[:96], s) for n, s in device_ops],
                 idle_gaps=_label_gaps(gaps, host))


def _label_gaps(gaps, host):
    """Idle seconds by what the host was doing when each gap opened: the
    innermost host op or range open at that moment on the busiest host
    thread."""
    count: Dict[int, int] = {}
    for *_, th in host:
        count[th] = count.get(th, 0) + 1
    thread = max(count, key=count.get) if count else None
    evs = sorted(((a, -b, name) for a, b, name, th in host if th == thread))
    totals: Dict[str, float] = {}
    stack: List[Tuple[float, str]] = []
    i = 0
    for a, b in sorted(gaps):
        while i < len(evs) and evs[i][0] <= a:
            s, neg_end, name = evs[i]
            while stack and stack[-1][0] <= s:
                stack.pop()
            stack.append((-neg_end, name))
            i += 1
        while stack and stack[-1][0] <= a:
            stack.pop()
        label = stack[-1][1] if stack else "host outside any range"
        totals[label] = totals.get(label, 0.0) + (b - a)
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    return [(n[:96], s) for n, s in top]
