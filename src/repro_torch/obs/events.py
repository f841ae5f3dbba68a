"""Structured JSON-lines event log (DESIGN.md §13) — counterpart of
`repro.obs.events`, a copy (standard library only).

One event = one dict with a monotone `seq`, a clock timestamp `ts`, an
`event` type string, and arbitrary JSON-able payload fields. Events are
kept in memory (the tests and run summaries read them back) and,
when a path is given, streamed to a JSON-lines file as they happen —
a crashed run still leaves every event up to the crash on disk.

Event types the serving stack emits (schema in DESIGN.md §13):
`submit`, `admit`, `prefill`, `first_token`, `decode`, `finish`,
`deadlock` — plus the terminal `run_end` this module appends itself on
`close()`. `run_end` carries the count of every preceding event by
type, so a consumer (`benchmarks/check_metrics.py`) can detect a
truncated file: either the terminal record is missing entirely, or its
counters disagree with the lines that made it to disk.

The log is intentionally dumb: no levels, no filtering — whoever
attaches a telemetry object has opted into the full stream.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

#: the terminal event type `close()` appends
RUN_END = "run_end"


class EventLog:
    def __init__(self, path: Optional[str] = None, clock=None,
                 keep_in_memory: bool = True):
        self.clock = clock if clock is not None else time.monotonic
        self.path = path
        self.events: List[Dict[str, object]] = []
        self._keep = keep_in_memory
        self._fh = open(path, "w") if path else None
        self._seq = 0
        #: per-type counts, maintained even when keep_in_memory=False
        #: so run_end can always carry the full tally
        self._counts: Dict[str, int] = {}
        self._closed = False

    def emit(self, event: str, **fields) -> Dict[str, object]:
        if self._closed:
            raise RuntimeError("EventLog is closed (run_end emitted)")
        ev: Dict[str, object] = {
            "seq": self._seq, "ts": round(float(self.clock()), 6),
            "event": event,
        }
        ev.update(fields)
        self._seq += 1
        self._counts[event] = self._counts.get(event, 0) + 1
        if self._keep:
            self.events.append(ev)
        if self._fh is not None:
            self._fh.write(json.dumps(ev) + "\n")
        return ev

    def of(self, event: str) -> List[Dict[str, object]]:
        return [e for e in self.events if e["event"] == event]

    def counts(self) -> Dict[str, int]:
        """Per-type event tally (excludes run_end until it is emitted)."""
        return dict(self._counts)

    def __len__(self) -> int:
        return self._seq

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        """Emit the terminal `run_end` event (with the per-type tally of
        everything emitted before it), flush, and close the stream.
        Idempotent; further `emit` calls raise."""
        if self._closed:
            return
        tally = dict(self._counts)
        n_before = self._seq
        self.emit(RUN_END, events=n_before, by_type=tally)
        self._closed = True
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
