"""Reductions the metric readers (`bench/metrics/<name>.py`) share: tails
over a run's stamps, tick walls, and the work of the profiled stretch
priced with the frozen closed forms of `bench/work.py`.

A reader returns None where it finds nothing to read; the run then
leaves that metric out of its line.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

from . import work


def nearest_rank(values: Sequence[float], pct: float) -> Optional[float]:
    """The `pct`-th percentile by nearest rank: the smallest value with at
    least `pct`% of the sample at or below it."""
    if not values:
        return None
    vals = sorted(values)
    return vals[max(math.ceil(pct / 100.0 * len(vals)), 1) - 1]


def ttfts(record) -> List[float]:
    """Seconds from due to first token of every request due in the window;
    one never served counts as waiting until the run ended."""
    return [(r.stamps[0] if r.stamps else record.t_end) - r.due
            for r in record.due_in_window()]


def token_gaps(record) -> List[float]:
    """Every gap between consecutive token stamps of the requests due in
    the window."""
    out = []
    for r in record.due_in_window():
        out.extend(b - a for a, b in zip(r.stamps, r.stamps[1:]))
    return out


def decode_only_tick_s(record) -> Optional[float]:
    """Mean wall of the window's ticks that decoded and prefilled
    nothing."""
    walls = [t.t1 - t.t0 for t in record.window_ticks()
             if t.decoded and not t.first]
    return sum(walls) / len(walls) if walls else None


# ---------------------------------------------------------------------------
# the profiled stretch
# ---------------------------------------------------------------------------

def _hd(model):
    return model.get("head_dim") or model["d_model"] // model["n_heads"]


def _block(record):
    return int(record.serving["block_size"])


def stretch_prefills(record) -> List[int]:
    """Prompt lengths of the requests prefilled in the stretch."""
    return [record.reqs[uid].prompt_len
            for t in record.stretch_ticks() for uid in t.first]


def stretch_model_flops(record, prefill_only: bool = False) -> float:
    """Model FLOPs of every token computed in the stretch: whole prompts
    and their logits row, decoded tokens with the keys they saw."""
    m = record.model
    total = sum(work.prefill_flops(m, n) for n in stretch_prefills(record))
    if not prefill_only:
        total += sum(work.decode_flops(m, keys)
                     for t in record.stretch_ticks() for _, keys in t.decoded)
    return total


def k1_bound_s(record) -> float:
    """Bound seconds of the stretch's K1 launches: one per layer of each
    decode tick, over every slot (an idle slot holds one key)."""
    m = record.model
    total = 0.0
    for t in record.stretch_ticks():
        if not t.decoded:
            continue
        lengths = [keys for _, keys in t.decoded]
        lengths += [1] * (record.n_slots - len(lengths))
        total += m["n_layers"] * work.bound_s(work.k1_work(
            lengths, n_heads=m["n_heads"], head_dim=_hd(m),
            n_kv=m["n_kv_heads"], window=record.table_width * _block(record),
            block_size=_block(record), table_width=record.table_width))
    return total


def k2_bound_s(record) -> float:
    """Bound seconds of the stretch's K2 launches: one per layer of each
    prompt prefilled, its rows padded to the page size."""
    m, bs = record.model, _block(record)
    total = 0.0
    for n in stretch_prefills(record):
        total += m["n_layers"] * work.bound_s(work.k2_work(
            [(0, n)], q_rows=-(-n // bs) * bs, n_heads=m["n_heads"],
            head_dim=_hd(m), n_kv=m["n_kv_heads"],
            window=record.table_width * bs, block_size=bs,
            table_width=record.table_width))
    return total


def bitplane_bound_s(record, kernel: str) -> float:
    """Bound seconds of the stretch's calls of one bit-plane kernel, from
    the rows, K and M each call was given."""
    w = record.serving["weights"]
    return sum(work.bound_s(work.bitplane_work(
        rows, k, m, n_bits=w["n_bits"], group=w["group"]))
        for name, rows, k, m in record.bitplane_calls if name == kernel)


def roofline_pct(record, kernel_range: str, bound) -> Optional[float]:
    """A kernel's share of its roofline: `bound(record)`, its bound
    seconds in the stretch, over the device seconds of its range."""
    t = record.trace
    dev = None if t is None else t.device_s(kernel_range)
    if not dev:
        return None
    b = bound(record)
    return 100.0 * b / dev if b > 0 else None


def idle_pct(record) -> Optional[float]:
    t = record.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
