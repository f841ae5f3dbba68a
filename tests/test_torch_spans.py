"""The serving tick's host spans (`obs.SpanRing` in `ServeTelemetry`).

On the f32 qwen2-1.5b smoke model, paged drains on the CPU with the
kernels' plain versions: the span tree of each `step()`, one first-token
span per admission and one sync span per decode, nothing allocated or
mutated with telemetry off, the ring's overwrite and drop count, the
registry / Prometheus text / event log unchanged by the spans, and the
spans on the profiler's clock. Span clocks are injected as integer
counters, as the lifecycle stamps take a `ManualClock`.
"""

import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import init_lm
from repro_torch.serve import ContinuousBatcher, Request, ServeConfig, \
    ServeEngine

N_SLOTS, BLOCK, NEW_TOKENS = 3, 4, 5
ADMISSION = ["serve/admit", "serve/paged_prefill", "serve/first_token"]
DECODE = ["serve/decode_prep", "serve/paged_decode", "serve/sync",
          "serve/retire"]


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype="float32")
    return cfg, init_lm(cfg, torch.Generator().manual_seed(0), "cpu")


def _prompts(vocab, n=5, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(4, 22))).astype(np.int32)
            for _ in range(n)]


def _ns_clock(step=10):
    return itertools.count(0, step).__next__


def _drain(model, telemetry, n=5, **kw):
    """Drain `n` requests one `step()` at a time; returns the tokens, the
    batcher and, per step, the seq range of the spans it opened."""
    cfg, params = model
    cb = ContinuousBatcher(cfg, params, n_slots=N_SLOTS, cache_len=40,
                           paged=True, block_size=BLOCK, kernel_impl="ref",
                           device="cpu", telemetry=telemetry, **kw)
    for uid, p in enumerate(_prompts(cfg.vocab_size, n)):
        cb.submit(Request(uid=uid, prompt=p, max_new_tokens=NEW_TOKENS))
    marks = []
    while cb.queue or any(s is not None for s in cb.slots):
        n0 = None if telemetry is None else telemetry.span_count
        cb.step()
        if telemetry is not None:
            marks.append((n0, telemetry.span_count))
    return {u: list(v) for u, v in cb.finished.items()}, cb, marks


@pytest.mark.parametrize("kw", [dict(prefix=True), dict(prefill_chunk=8)],
                         ids=["prefix", "chunked"])
def test_each_step_is_one_tick_span_tree(model, kw):
    tel = obs.ServeTelemetry(clock=obs.ManualClock(), span_clock=_ns_clock())
    _, cb, marks = _drain(model, tel, **kw)
    recs = {r.seq: r for r in tel.span_records()}
    assert tel.spans.dropped == 0 and len(recs) == tel.span_count
    admitted = []
    for a, b in marks:
        spans = [recs[s] for s in range(a, b)]
        root = spans[0]
        assert (root.name, root.parent, root.uid) == ("serve/tick", -1, -1)
        kids = spans[1:]
        assert all(s.parent == root.seq for s in kids)
        # siblings in order, each inside the root, none overlapping
        for x, y in zip(kids, kids[1:]):
            assert x.end_ns < y.start_ns
        assert all(root.start_ns < s.start_ns < s.end_ns < root.end_ns
                   for s in kids)
        names = [s.name for s in kids]
        if names[-4:] == DECODE:
            assert all(s.uid == -1 for s in kids[-4:])
            names = names[:-4]
        # what is left: admissions, and chunks of an earlier one
        i = 0
        while i < len(names):
            if names[i] == "serve/admit":
                group = kids[i: i + 3] if names[i: i + 3] == ADMISSION \
                    else kids[i: i + 2]
                assert [s.name for s in group] == ADMISSION[:len(group)]
                assert len({s.uid for s in group}) == 1
                admitted.append(group[0].uid)
                i += len(group)
            else:
                assert names[i] == "serve/paged_prefill" and kw.get(
                    "prefill_chunk"), names
                i += 1 + (names[i + 1: i + 2] == ["serve/first_token"])
    assert sorted(admitted) == sorted(cb.finished)


def test_one_first_token_per_admission_and_one_sync_per_decode(model):
    tel = obs.ServeTelemetry(clock=obs.ManualClock(), span_clock=_ns_clock())
    tokens, cb, _ = _drain(model, tel, n=6, prefix=True)
    names = [r.name for r in tel.span_records()]
    first = [r.uid for r in tel.span_records()
             if r.name == "serve/first_token"]
    assert sorted(first) == sorted(tokens) == list(range(6))
    assert len(first) == len(tel.events.of("first_token"))
    decodes = tel.registry.counter("kernel_launches",
                                   {"kind": "decode"}).value
    assert names.count("serve/sync") == decodes == cb.ticks > 0
    assert names.count("serve/paged_decode") == decodes
    assert names.count("serve/tick") == tel.registry.counter(
        "serve_ticks").value


def test_metrics_off_allocates_no_span_store(model, monkeypatch):
    def refuse(self, *a, **k):
        raise AssertionError("a span store was allocated")
    monkeypatch.setattr(obs.SpanRing, "__init__", refuse)
    before = obs.mutation_count()
    tokens, cb, _ = _drain(model, None, prefix=True)
    assert obs.mutation_count() == before
    assert cb.telemetry is None and len(tokens) == 5


def test_ring_overwrites_the_oldest_span_and_counts_the_drop():
    ring = obs.SpanRing(capacity=4, clock=_ns_clock(1))
    ring.begin("outer")
    for i in range(2):
        ring.begin("inner", uid=i)
        ring.end()
    ring.end()
    for name in ("a", "b", "c"):
        ring.begin(name)
        ring.end()
    assert ring.opened == 6 and ring.dropped == 2
    got = ring.records()
    assert [r.seq for r in got] == [2, 3, 4, 5]
    assert [r.name for r in got] == ["inner", "a", "b", "c"]
    assert [r.parent for r in got] == [0, -1, -1, -1]
    assert [r.uid for r in got] == [1, -1, -1, -1]
    assert all(r.end_ns == r.start_ns + 1 for r in got)
    assert ring.records(since=4) == got[2:]
    summary = ring.summary()
    assert summary["dropped"] == 2 and summary["opened"] == 6
    assert summary["by_name"]["inner"]["n"] == 1
    assert summary["by_name"]["a"]["total_s"] == pytest.approx(1e-9)
    assert "outer" not in summary["by_name"]
    # a root discards what an exception left open, unrecorded
    ring.begin("left open")
    ring.begin_root("serve/tick")
    ring.end_all()
    tail = ring.records(since=6)
    assert [(r.name, r.parent) for r in tail] == [("serve/tick", -1)]
    with pytest.raises(ValueError):
        obs.SpanRing(capacity=0)


def _exports(tel):
    return (json.dumps(tel.summary(), sort_keys=True),
            tel.registry.prometheus(), json.dumps(tel.events.events))


def test_registry_prometheus_and_events_equal_with_spans_on_and_off(
        model, monkeypatch):
    on = obs.ServeTelemetry(clock=obs.ManualClock(0.0, tick=0.5),
                            span_clock=_ns_clock())
    tokens_on, _, _ = _drain(model, on, prefix=True)
    assert on.span_count > 0
    with monkeypatch.context() as m:
        for name in ("begin", "end", "begin_root", "end_all"):
            m.setattr(obs.SpanRing, name, lambda self, *a, **k: None)
        off = obs.ServeTelemetry(clock=obs.ManualClock(0.0, tick=0.5),
                                 span_clock=_ns_clock())
        tokens_off, _, _ = _drain(model, off, prefix=True)
    assert off.span_count == 0
    assert tokens_on == tokens_off
    assert _exports(on) == _exports(off)
    assert "span" not in _exports(on)[0]


def _kineto(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()


def test_decode_ops_lie_inside_their_span_on_the_profiler_clock(model):
    """Under `torch.profiler`, every `aten::` op of each decode step's
    profiler range lies inside the ring's `serve/paged_decode` span of
    that step, whose stamps come from `time.time_ns`, within 1 ms."""
    tel = obs.ServeTelemetry(profile=True)
    _, events = _kineto(lambda: _drain(model, tel, n=3, prefix=True))
    spans = [r for r in tel.span_records() if r.name == "serve/paged_decode"]
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in events if e.name() == "serve/paged_decode")
    assert len(ranges) == len(spans) > 0
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in events if e.name().startswith("aten::")]
    slack = 1_000_000
    checked = 0
    for (lo, hi), span in zip(ranges, spans):
        inside = [op for op in ops if lo <= op[0] and op[1] <= hi]
        assert inside
        for a, b in inside:
            assert span.start_ns - slack <= a and b <= span.end_ns + slack
        checked += len(inside)
    assert checked > 10 * len(spans)


def test_profile_spans_name_the_engine_steps(model):
    """`ServeEngine.generate` names each step call by its span: one
    profiler range per prefill chunk and per decode step."""
    cfg, params = model
    tel = obs.ServeTelemetry(clock=obs.ManualClock(), profile=True)
    eng = ServeEngine(cfg, params, ServeConfig(
        max_cache_len=32, max_new_tokens=4, paged=True, block_size=4,
        prefill_chunk=4, kernel_impl="ref", device="cpu"), telemetry=tel)
    prompts = np.random.default_rng(1).integers(0, 128, (2, 10))
    _, events = _kineto(lambda: eng.generate(prompts))
    names = [e.name() for e in events]
    assert names.count("serve/paged_prefill") == 3      # ceil(10 / 4)
    assert names.count("serve/paged_decode") == 3       # 4 tokens
    got = [r.name for r in tel.span_records()]
    assert got == ["serve/paged_prefill"] * 3 + ["serve/paged_decode"] * 3


def test_launcher_metrics_block_prints_the_span_summary(capsys):
    launch_serve.main(["--paged", "--device", "cpu", "--requests", "3",
                       "--new-tokens", "3", "--metrics"])
    out = capsys.readouterr().out
    assert "  spans (" in out
    for name in ("serve/tick", "serve/admit", "serve/paged_prefill",
                 "serve/first_token", "serve/decode_prep",
                 "serve/paged_decode", "serve/sync", "serve/retire"):
        assert f"    {name}: n=" in out, name
