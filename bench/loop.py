"""The host loop that offers a traffic mix to the batcher and stamps what
comes back.

One thread: submit what is due, call `step()`, read the host clock. Every
tick of the batcher ends in a host sync (it brings the tick's tokens to
the host), so a stamp taken after `step()` returns closes on finished
work. A token counts at the stamp of the tick that produced it.

Phases: warm (the traffic runs until the slots are in steady state), the
window (`seconds` long: it opens and closes on tick stamps), in an open
loop the follow (ticks go on, with arrivals on schedule, until every
request due in the window has finished, or `follow_s` has passed), and in
a traced run the profiled stretch, after all of them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .traffic import Stream


@dataclasses.dataclass
class Req:
    uid: int
    prompt: np.ndarray
    max_new: int
    due: float                   # when it fell due (host clock)
    stamps: List[float] = dataclasses.field(default_factory=list)
    tokens: Optional[List[int]] = None   # the served tokens, once finished
    handle: object = None        # the program's Request

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass
class Tick:
    t0: float
    t1: float
    first: List[int]                      # uids given their first token
    decoded: List[Tuple[int, int]]        # (uid, keys the token saw)
    queued: int                           # requests waiting after the tick


@dataclasses.dataclass
class Record:
    """Everything a run saw, for the metric readers."""
    model: dict
    serving: dict
    traffic: dict
    n_slots: int
    table_width: int
    seconds: float
    reqs: Dict[int, Req] = dataclasses.field(default_factory=dict)
    ticks: List[Tick] = dataclasses.field(default_factory=list)
    t_open: float = 0.0
    t_close: float = 0.0
    t_end: float = 0.0
    stretch: Optional[Tuple[int, int]] = None   # profiled ticks [a, b)
    trace: object = None                       # trace.Trace
    bitplane_calls: List[Tuple[str, int, int, int]] = dataclasses.field(
        default_factory=list)                  # (kernel, rows, K, M)
    admit_ts: Dict[int, float] = dataclasses.field(default_factory=dict)
    setup_s: float = 0.0
    memory_peak_bytes: int = 0
    lateness_max_s: float = 0.0

    # -- views the readers share ------------------------------------------

    def window_ticks(self) -> List[Tick]:
        return [t for t in self.ticks
                if t.t1 > self.t_open and t.t1 <= self.t_close]

    def stretch_ticks(self) -> List[Tick]:
        if self.stretch is None:
            return []
        return self.ticks[self.stretch[0]: self.stretch[1]]

    def due_in_window(self) -> List[Req]:
        return [r for r in self.reqs.values()
                if self.t_open <= r.due < self.t_close]

    def finished_in_window(self) -> List[Req]:
        return [r for r in self.reqs.values() if r.tokens is not None
                and self.t_open < r.stamps[-1] <= self.t_close]


def drive(batcher, request_cls, stream: Stream, traffic: dict,
          record: Record, clock: Callable[[], float] = time.perf_counter,
          tracer=None, stretch_ticks: int = 24, window=None) -> Record:
    """Offer `stream` to `batcher` and fill `record`. With `tracer` (traced
    runs) the traffic goes on after the window (and, in an open loop,
    after the follow) for `stretch_ticks` more ticks under the profiler,
    so the profiler's own host cost touches no tick or request the
    window's metrics read. `window`, if given, is told when the window
    opens (`open()`), after each of its ticks (`tick()`) and when it
    closes (`close()`)."""
    closed = traffic["loop"] == "closed"
    inflight: Dict[int, Req] = {}
    pending: List[Req] = []          # due, not yet submitted
    t_start = clock()
    state = {"next": None}

    def new_req(draw, due) -> Req:
        r = Req(uid=draw.index, prompt=draw.prompt,
                max_new=draw.max_new_tokens, due=due)
        record.reqs[r.uid] = r
        return r

    if closed:
        pending = [new_req(d, t_start)
                   for d in stream.first_wave(int(traffic["clients"]))]
    else:
        nxt = stream.next()
        state["next"] = (nxt, t_start + nxt.gap_s)

    def submit_due(now):
        nxt = state["next"]
        while nxt is not None and nxt[1] <= now:
            pending.append(new_req(*nxt))
            d = stream.next()
            nxt = (d, nxt[1] + d.gap_s)
        state["next"] = nxt
        keep = []
        for r in pending:
            if r.due <= now:
                record.lateness_max_s = max(record.lateness_max_s,
                                            now - r.due)
                r.handle = request_cls(uid=r.uid, prompt=r.prompt,
                                       max_new_tokens=r.max_new)
                batcher.submit(r.handle)
                inflight[r.uid] = r
            else:
                keep.append(r)
        pending[:] = keep

    def tick() -> float:
        """Submit what is due (sleeping while nothing is in flight), run
        one step, stamp it; returns the stamp."""
        submit_due(clock())
        while not inflight:
            wake = min([r.due for r in pending]
                       + ([state["next"][1]] if state["next"] else []))
            time.sleep(max(0.0, wake - clock()))
            submit_due(clock())
        t0 = clock()
        batcher.step()
        t1 = clock()
        tk = Tick(t0, t1, [], [], 0)
        for uid, r in list(inflight.items()):
            n = len(r.handle.generated)
            new = n - len(r.stamps)
            if new <= 0:
                continue
            if not r.stamps:
                tk.first.append(uid)
                new -= 1
            if new > 0:
                tk.decoded.append((uid, r.prompt_len + n - 1))
            r.stamps.extend([t1] * (n - len(r.stamps)))
            if uid in batcher.finished:
                r.tokens = list(batcher.finished[uid])
                del inflight[uid]
                if closed:
                    pending.append(new_req(
                        stream.next(),
                        t1 + float(traffic.get("think_s", 0.0))))
        tk.queued = len(batcher.queue)
        record.ticks.append(tk)
        return t1

    # warm: an open loop from its start, a closed one from the fill's end
    t1 = tick()
    warm_until = (t_start if not closed else t1) + float(traffic["warm_s"])
    while t1 < warm_until:
        t1 = tick()
    t_open = t1
    if window is not None:
        window.open()
    while t1 < t_open + record.seconds:
        t1 = tick()
        if window is not None:
            window.tick()
    t_close = t1
    if window is not None:
        window.close()
    if not closed:
        follow_until = t_close + float(traffic.get("follow_s", 60.0))
        while t1 < follow_until and any(
                r.tokens is None for r in record.reqs.values()
                if t_open <= r.due < t_close):
            t1 = tick()
    record.t_open, record.t_close, record.t_end = t_open, t_close, clock()
    if tracer is not None:
        tracer.start()
        first = len(record.ticks)
        for _ in range(stretch_ticks):
            tick()
        tracer.stop()
        record.stretch = (first, len(record.ticks))
    return record
