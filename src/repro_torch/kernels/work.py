"""The work each kernel dispatch does, reported at its dispatch point.

K1-K4 launch through `ctypes`, which no `TorchDispatchMode` sees, and
their plain versions run aten ops that are not the kernel's work (K3's
plain version unpacks the planes and multiplies in f32). So each
dispatch point — `paged_attention.paged_attention` (K1),
`paged_prefill.paged_prefill` (K2) and `ops.bitplane_matmul` (K3/K4) —
runs its body inside `dispatch(name, work)`, and says what the kernel
must do, from the shapes (and, for the attention kernels, the lengths):

  K1 / K2  FLOPs 4 * hd * H * visible (query, key) pairs; bytes the
           visible K/V rows (and their page scales), q, the f32 output,
           the table and the per-slot vectors, each once
  K3 / K4  FLOPs 2 * B * K * M, the dense product they replace; bytes
           the planes, the scale, x and y, each once
  K6       K3's FLOPs over the (token, expert) pairs; bytes the planes
           and scales of the experts that can have rows, x and the f32
           output (`k6_work`, from `ops.bitplane_grouped_matmul`)

the formulas `chip_smoke.py`'s `bound()` is fed with. The work is the
same whichever route implements the kernel.

A loop on meta tensors whose steps are alike (`models.scan`) runs one
step for many: inside `repeat(k)` (and between `enter_repeat(k)` /
`leave_repeat(k)`, which the step's autograd nodes call in the backward)
every op and dispatch counts k times, the product of the repeats open.

Nothing is computed unless someone listens: `WorkMeter` (the roofline's
count) records each dispatch's work, `KernelScopes` (the dispatch lint)
only tracks that a dispatch is open. While any dispatch is open,
`inside()` is true, and a counter of aten ops skips them: the plain
route's ops are the kernel's work, already reported, and are not counted
twice. Computing the work reads the lengths on the host, so it happens
only under a meter, never in a timed or linted step.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Tuple

import torch

#: the listeners now open (meters and scope trackers), innermost last
_LISTENERS: List["KernelScopes"] = []
#: the repeat factors now open (`repeat`), innermost last
_REPEATS: List[int] = []


def repeats() -> int:
    """How many times an op or dispatch counts now."""
    return math.prod(_REPEATS)


def enter_repeat(k: int) -> None:
    _REPEATS.append(k)


def leave_repeat(k: int) -> None:
    _REPEATS.remove(k)


@contextlib.contextmanager
def repeat(k: int):
    """Ops and dispatches inside count `k` times each."""
    enter_repeat(k)
    try:
        yield
    finally:
        leave_repeat(k)


class KernelScopes:
    """Tracks how many kernel dispatches are open while it is entered."""

    def __init__(self):
        self.depth = 0

    def __enter__(self):
        _LISTENERS.append(self)
        return self

    def __exit__(self, *exc):
        _LISTENERS.remove(self)
        return False

    def record(self, name: str, flops: float, nbytes: float) -> None:
        pass

    wants_work = False


class WorkMeter(KernelScopes):
    """Records `(kernel, flops, bytes)` for every dispatch while entered."""

    wants_work = True

    def __init__(self):
        super().__init__()
        self.records: List[Tuple[str, float, float, int]] = []

    def record(self, name: str, flops: float, nbytes: float) -> None:
        k = repeats()
        self.records.append((name, k * float(flops), k * float(nbytes), k))

    @property
    def flops(self) -> float:
        return sum(r[1] for r in self.records)

    @property
    def bytes(self) -> float:
        return sum(r[2] for r in self.records)

    def by_kernel(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name, f, b, k in self.records:
            e = out.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
            e["calls"] += k
            e["flops"] += f
            e["bytes"] += b
        return out


def inside() -> bool:
    """True while a kernel dispatch is open under some listener."""
    return any(s.depth for s in _LISTENERS)


class dispatch:
    """The body of one kernel dispatch (`with dispatch(name, work):`):
    each listener sees it open, and each meter records `work()` (FLOPs,
    bytes), evaluated once. With no listener it does nothing (a class, not
    a generator, to keep that path cheap on every projection)."""

    __slots__ = ("name", "work", "listeners")

    def __init__(self, name: str, work: Callable[[], Tuple[float, float]]):
        self.name, self.work, self.listeners = name, work, ()

    def __enter__(self):
        if not _LISTENERS:
            return self
        self.listeners = tuple(_LISTENERS)
        for s in self.listeners:
            s.depth += 1
        if any(s.wants_work for s in self.listeners):
            try:
                flops, nbytes = self.work()
            except BaseException:
                self.__exit__()
                raise
            for s in self.listeners:
                s.record(self.name, flops, nbytes)
        return self

    def __exit__(self, *exc):
        for s in self.listeners:
            s.depth -= 1
        self.listeners = ()
        return False


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _pages(lo: int, hi: int, bs: int) -> int:
    """Pages holding positions [lo, hi)."""
    return 0 if hi <= lo else -(-hi // bs) - lo // bs


def decode_work(q, k_pages, block_table, lengths, window, k_scales=None,
                block_start=None) -> Tuple[float, float]:
    """K1: one query at `len - 1` per slot sees `min(len, window)` keys."""
    b, h, hd = q.shape
    _, bs, n_kv, _ = k_pages.shape
    rows = pages = 0
    for n in lengths.tolist():
        lo = max(n - int(window), 0)
        rows += n - lo
        pages += _pages(lo, n, bs)
    kv_bytes = 2 * rows * n_kv * hd * k_pages.element_size()
    if k_scales is not None:
        kv_bytes += 2 * pages * n_kv * 4
    nbytes = (kv_bytes + _nbytes(q) + b * h * hd * 4 + _nbytes(block_table)
              + _nbytes(lengths) + _nbytes(block_start))
    return 4.0 * hd * h * rows, float(nbytes)


def _keys_seen(lo: int, hi: int, window: int) -> int:
    """Sum over query positions [lo, hi) of min(pos + 1, window)."""
    if hi <= lo:
        return 0
    c = min(hi, window)            # positions below c see pos + 1 keys
    n = c * (c + 1) // 2 - lo * (lo + 1) // 2 if c > lo else 0
    return n + (hi - max(lo, c)) * window


def prefill_work(q, k_pages, block_table, start, total, window,
                 k_scales=None, block_start=None) -> Tuple[float, float]:
    """K2: suffix row t of a slot sits at `start + t`; a valid row
    (`start + t < total`) sees `min(start + t + 1, window)` keys."""
    b, t, h, hd = q.shape
    _, bs, n_kv, _ = k_pages.shape
    w = int(window)
    pairs = rows = pages = 0
    for s, tot in zip(start.tolist(), total.tolist()):
        end = min(tot, s + t)
        pairs += _keys_seen(s, end, w)
        if end > s:
            lo = max(s - w + 1, 0)
            rows += tot - lo
            pages += _pages(lo, tot, bs)
    kv_bytes = 2 * rows * n_kv * hd * k_pages.element_size()
    if k_scales is not None:
        kv_bytes += 2 * pages * n_kv * 4
    nbytes = (kv_bytes + _nbytes(q) + b * t * h * hd * 4
              + _nbytes(block_table) + _nbytes(start) + _nbytes(total)
              + _nbytes(block_start))
    return 4.0 * hd * h * pairs, float(nbytes)


def bitplane_work(x: torch.Tensor, planes: torch.Tensor,
                  scale: torch.Tensor) -> Tuple[float, float]:
    """K3/K4: the dense [B, K] @ [K, M] product they replace."""
    k = x.shape[-1]
    rows = x.numel() // max(k, 1)
    m = planes.shape[-1]
    nbytes = (_nbytes(planes) + _nbytes(scale) + _nbytes(x)
              + rows * m * x.element_size())
    return 2.0 * rows * k * m, float(nbytes)


def grouped_work(x: torch.Tensor, planes: torch.Tensor, n_bits: int,
                 group: int) -> Tuple[float, float]:
    """K6: `k6_work` at x's rows (the pairs) and the stack's shapes."""
    pairs, k = x.shape
    return k6_work(pairs, k, planes.shape[-1], n_experts=planes.shape[0],
                   n_bits=n_bits, group=group, x_elt=x.element_size())


# ---------------------------------------------------------------------------
# closed forms on plain ints: K6 and a mixture of experts' model FLOPs
# (the benchmark keeps a frozen copy, bench/work_moe.py)
# ---------------------------------------------------------------------------

def k6_work(pairs: int, k: int, m: int, *, n_experts: int, n_bits: int = 8,
            group: int = 1, x_elt: int = 2) -> Tuple[float, float]:
    """K6 over `pairs` (token, expert) rows of a [K -> M] expert stack:
    FLOPs 2 * pairs * K * M; bytes the planes and f32 scales of the
    `min(E, pairs)` experts that can have rows, the pairs' x and their
    f32 output, each once."""
    nd = -(-n_bits // group)
    per_expert = nd * (k * group // 8) * m + 4 * m
    nbytes = (min(n_experts, pairs) * per_expert + pairs * k * x_elt
              + pairs * m * 4)
    return 2.0 * pairs * k * m, float(nbytes)


def _global_layers(model: dict) -> int:
    """Layers attending over the whole sequence (`window_schedule`)."""
    n, r = model["n_layers"], model.get("local_global_ratio", 0)
    if r <= 0 or model.get("sliding_window", 0) <= 0:
        return n
    return sum(1 for l in range(n) if l % (r + 1) == r)


def moe_active_params(model: dict) -> int:
    """Matmul parameters one token goes through in one layer: the
    attention projections, the router and `top_k` routed experts (and a
    shared expert of `d_ff * n_shared_experts`)."""
    d, h, kv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // h
    f, e = model["d_ff"], model["n_experts"]
    shared = model.get("n_shared_experts", 0)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    return attn + d * e + (model["top_k"] + shared) * 3 * d * f


def moe_token_flops(model: dict) -> float:
    """2 x the active matmul parameters over every layer."""
    return 2.0 * model["n_layers"] * moe_active_params(model)


def moe_visible_pairs(model: dict, lo: int, hi: int) -> int:
    """(query, key) pairs of query positions [lo, hi) summed over the
    layers: the whole prefix on global layers, the window on the
    others."""
    glob = _global_layers(model)
    local = model["n_layers"] - glob
    full = hi * (hi + 1) // 2 - lo * (lo + 1) // 2
    w = model.get("sliding_window", 0)
    windowed = 0
    if local:
        c = min(hi, w)
        windowed = (c * (c + 1) // 2 - lo * (lo + 1) // 2 if c > lo else 0)
        windowed += (hi - max(lo, c)) * w
    return glob * full + local * windowed


def moe_prefill_flops(model: dict, prompt: int) -> float:
    """A whole prompt: its tokens through the active parameters, its
    visible pairs at 4 * hd * H each, and one logits row."""
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    return (prompt * moe_token_flops(model)
            + 4.0 * hd * model["n_heads"] * moe_visible_pairs(model, 0,
                                                                prompt)
            + 2.0 * model["d_model"] * model["vocab_size"])


def moe_decode_flops(model: dict, visible: int) -> float:
    """One decoded token that sees `visible` keys (its own included) on a
    global layer, and at most the window on the others; its logits
    included."""
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    return (moe_token_flops(model)
            + 4.0 * hd * model["n_heads"] * moe_visible_pairs(
                model, visible - 1, visible)
            + 2.0 * model["d_model"] * model["vocab_size"])
