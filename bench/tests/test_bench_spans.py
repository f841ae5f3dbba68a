"""The span readers on synthetic records with known spans, device
intervals and pool gauges; `Probe` and `collect` on a drain of the
program's batcher with its telemetry, on the CPU; and the readers on
records of today's harness, which keeps no spans."""

import collections
from pathlib import Path

import numpy as np
import pytest

from bench import reduce, spans, trace
from bench import run as bench_run
from bench.loop import Record, Tick
from bench.tests import bench_fixture

REPO = Path(__file__).resolve().parents[2]
SPAN_METRICS = ("decode_dispatch_ms", "host_syncs_per_tick",
                "idle_in_dispatch_pct", "idle_in_scheduler_pct",
                "kv_reserved_unused_pct")
S = collections.namedtuple("S", "seq name start_ns end_ns parent uid")
MS = 1_000_000


def reader(name):
    return bench_run.load_reader(REPO, name)


def tree(seq0, t0_ns, children):
    """A `serve/tick` root at `t0_ns` and its children back to back:
    `children` is `(name, length_ns, uid)`; 1 ns of the root's own work
    before, between and after them."""
    out, t = [], t0_ns + 1
    for i, (name, length, uid) in enumerate(children):
        out.append(S(seq0 + 1 + i, name, t, t + length, seq0, uid))
        t += length + 1
    return [S(seq0, "serve/tick", t0_ns, t, -1, -1)] + out


def decode(dispatch_ns):
    return [("serve/decode_prep", MS, -1),
            ("serve/paged_decode", dispatch_ns, -1),
            ("serve/sync", MS, -1), ("serve/retire", MS, -1)]


def admission(uid):
    return [("serve/admit", MS, uid), ("serve/paged_prefill", 5 * MS, uid),
            ("serve/first_token", MS, uid)]


def record(trees_and_ticks):
    """A record whose ticks carry the given span trees and pool gauges:
    `(t0, t1, first, decoded, tree, pool)` each."""
    r = Record(model={}, serving={"block_size": 16}, traffic={}, n_slots=4,
               table_width=8, seconds=10.0)
    r.t_open, r.t_close, r.t_end = 100.0, 110.0, 120.0
    r.spans = {}
    for t0, t1, first, decoded, sp, pool in trees_and_ticks:
        tk = Tick(t0, t1, first, decoded, 0)
        if sp is not None:
            tk.program = (sp[0].seq, sp[-1].seq + 1, pool)
            r.spans.update({s.seq: s for s in sp})
        r.ticks.append(tk)
    return r


def synthetic():
    warm = tree(0, 0, decode(900 * MS))
    opening = tree(5, 10**9, decode(800 * MS))
    a = tree(10, 2 * 10**9, decode(150 * MS))
    b = tree(15, 3 * 10**9, admission(7) + decode(400 * MS))
    c = tree(23, 4 * 10**9, decode(170 * MS))
    return record([
        (99.0, 99.5, [], [(1, 9)], warm, (100, 0, 0)),
        (99.5, 100.0, [], [(1, 10)], opening, (30, 0, 70)),
        (100.0, 100.2, [], [(1, 11)], a, (60, 50, 40)),
        (100.2, 100.5, [7], [(1, 12)], b, (55, 35, 45)),
        (100.5, 100.7, [], [(1, 13)], c, (50, 40, 50)),
        (110.0, 110.3, [], [(1, 14)], None, None),     # after the close
    ])


def test_window_ticks_matched_to_their_spans_warm_ones_left_out():
    r = synthetic()
    got = spans.window_spans(r)
    assert [sp[0].seq for sp in got] == [10, 15, 23]
    assert [sp[0].seq for sp in spans.window_spans(r, decode_only=True)] \
        == [10, 23]
    assert reader("decode_dispatch_ms")(r) == pytest.approx(160.0)
    assert reader("host_syncs_per_tick")(r) == pytest.approx(4 / 3)
    assert reader("kv_reserved_unused_pct")(r) == pytest.approx(
        100.0 * (10 / 100 + 20 / 100 + 10 / 100) / 3)
    # the opening tick counts for the peak, as `run._Window` reads it
    assert spans.pages_peak(r) == 70


def test_a_tick_not_matched_to_one_root_is_left_out():
    r = synthetic()
    # tick c's root loses its parent link: two roots in one step
    c0 = r.spans[24]
    r.spans[24] = c0._replace(parent=-1)
    assert [sp[0].seq for sp in spans.window_spans(r)] == [10, 15]
    # a span the ring no longer held: tick a is left out too
    del r.spans[12]
    assert [sp[0].seq for sp in spans.window_spans(r)] == [15]
    assert reader("decode_dispatch_ms")(r) is None
    assert reader("host_syncs_per_tick")(r) == pytest.approx(2.0)


def test_readers_find_nothing_without_the_programs_spans():
    r = Record(model={}, serving={}, traffic={}, n_slots=1, table_width=1,
               seconds=1.0)
    r.t_open, r.t_close = 0.0, 1.0
    r.ticks = [Tick(0.1, 0.2, [], [(0, 3)], 0)]
    for name in SPAN_METRICS:
        assert reader(name)(r) is None


def test_segments_label_each_instant_with_the_innermost_span():
    sp = [S(0, "serve/tick", 0, 100, -1, -1),
          S(1, "serve/admit", 10, 20, 0, 3),
          S(2, "serve/paged_decode", 30, 90, 0, -1),
          S(3, "inner", 40, 50, 2, -1)]
    got = [(round(a * 1e9), round(b * 1e9), n)
           for a, b, n in spans.segments(sp)]
    assert got == [(0, 10, "serve/tick"), (10, 20, "serve/admit"),
                   (20, 30, "serve/tick"), (30, 40, "serve/paged_decode"),
                   (40, 50, "inner"), (50, 90, "serve/paged_decode"),
                   (90, 100, "serve/tick")]


class Ev:
    """A stand-in for one of the profiler's raw events."""

    def __init__(self, kind, name, start_us, end_us, corr=0):
        self.kind, self._name = kind, name
        self.a, self.b, self.corr = start_us * 1000, end_us * 1000, corr

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a

    def correlation_id(self):
        return self.corr

    def start_thread_id(self):
        return 1


US = 1000


def stretch_fixture():
    """A 100 us stretch with two ticks and four launches; the test below
    works out each idle instant's term."""
    t1 = [S(0, "serve/tick", 10 * US, 60 * US, -1, -1)] + [
        S(i + 1, n, a * US, b * US, 0, u) for i, (n, a, b, u) in enumerate([
            ("serve/admit", 12, 15, 7), ("serve/paged_prefill", 15, 25, 7),
            ("serve/first_token", 25, 30, 7), ("serve/decode_prep", 31, 35, -1),
            ("serve/paged_decode", 35, 50, -1), ("serve/sync", 50, 55, -1),
            ("serve/retire", 55, 58, -1)])]
    t2 = [S(8, "serve/tick", 70 * US, 95 * US, -1, -1)] + [
        S(9 + i, n, a * US, b * US, 8, -1) for i, (n, a, b) in enumerate([
            ("serve/decode_prep", 71, 73), ("serve/paged_decode", 73, 85),
            ("serve/sync", 85, 90), ("serve/retire", 90, 94)])]
    events = [
        Ev("user_annotation", trace.STRETCH, 0, 100),
        Ev("cuda_runtime", "cudaLaunchKernel", 18, 19, corr=1),
        Ev("kernel", "k3", 20, 28, corr=1),
        Ev("cuda_runtime", "cudaLaunchKernel", 38, 39, corr=2),
        Ev("kernel", "k3", 40, 52, corr=2),
        Ev("cuda_runtime", "cudaLaunchKernel", 75, 76, corr=3),
        Ev("kernel", "k1", 80, 88, corr=3),
        # launched between ticks by the harness; runs past the stretch
        Ev("cuda_runtime", "cudaMemcpyAsync", 65, 66, corr=4),
        Ev("gpu_memcpy", "Memcpy HtoD", 101, 102, corr=4),
        # a runtime call with no device work: not a launch
        Ev("cuda_runtime", "cudaDeviceSynchronize", 99, 100, corr=5),
    ]
    return t1 + t2, events


def test_idle_split_terms_are_exact_and_sum_to_the_idle_share():
    sp, events = stretch_fixture()
    split = spans.idle_split(*spans.profiled(events), sp)
    # idle: [0, 20], [28, 40], [52, 80], [88, 100] of [0, 100] us
    assert split["harness"] == pytest.approx(10 + 10 + 5)
    assert split["scheduler"] == pytest.approx(2 + 3 + 1 + 4 + 3 + 2 + 1
                                               + 2 + 4 + 1)
    assert split["dispatch"] == pytest.approx(5 + 5 + 7)
    assert split["sync"] == pytest.approx(2 + 3 + 2)
    assert split["other"] == 0.0
    assert split["idle"] == pytest.approx(72.0)
    assert (split["launches"], split["launches_in_tick"]) == (4, 3)
    r = Record(model={}, serving={}, traffic={}, n_slots=1, table_width=1,
               seconds=1.0)
    r.trace = trace.reduce_events(events)
    r.idle_split = split
    assert sum(split[k] for k in spans.TERMS) == pytest.approx(
        reduce.idle_pct(r), abs=1e-9)
    assert reader("idle_in_dispatch_pct")(r) == split["dispatch"]
    assert reader("idle_in_scheduler_pct")(r) == split["scheduler"]


class OldEv(Ev):
    """An event of a profiler that does not say its kind."""

    activity_type = property()         # hasattr() is False

    def device_type(self):
        import torch
        dev = torch.autograd.DeviceType
        return dev.CPU if self.kind not in trace._DEVICE else dev.CUDA


def test_events_that_do_not_say_their_kind_read_alike():
    sp, events = stretch_fixture()
    new = spans.profiled(events)
    old = spans.profiled([OldEv(e.kind, e._name, e.a / 1000, e.b / 1000,
                                e.corr) for e in events])
    assert old == new
    assert new[0] == (0.0, 1e-4) and len(new[1]) == 4
    assert new[2] == pytest.approx([18e-6, 38e-6, 65e-6, 75e-6])


def test_stretch_split_reads_the_stretch_ticks_and_report_prints_checks(
        capsys):
    """`stretch_split` takes the profiler the tracer ran and the spans of
    the stretch's ticks; `report` prints the run's checks."""
    sp, events = stretch_fixture()
    r = record([(99.0, 100.0, [], [], sp[:8], (9, 4, 1)),
                (100.0, 100.5, [], [(1, 5)], sp[8:], (8, 3, 2))])
    r.stretch = (0, 2)
    kineto = type("K", (), {"events": lambda self: events})()
    prof = type("P", (), {"profiler": type("R", (), {
        "kineto_results": kineto})()})()
    tracer = type("T", (), {"_prof": prof})()
    r.idle_split = spans.stretch_split(tracer, r)
    assert r.idle_split == spans.idle_split(*spans.profiled(events), sp)
    spans.report(r, 0, 2, 72.0)
    err = capsys.readouterr().err.splitlines()
    assert err[0].startswith("[spans] 1 window ticks probed, 1 matched")
    assert err[1].startswith("[spans] window, per tick: 5.0 spans; ms: ")
    assert err[2] == ("[spans] pool gauges: peak 2 pages allocated in "
                      "the window (harness 2)")
    assert err[3].startswith("[spans] stretch: 3 of 4 device launches")
    assert err[4].startswith(f"[spans] idle {r.idle_split['idle']} % = "
                             f"sync {r.idle_split['sync']} + harness ")
    tracer._prof = None
    assert spans.stretch_split(tracer, r) is None


def test_idle_split_with_no_device_work_is_the_whole_stretch():
    sp, events = stretch_fixture()
    host_only = [e for e in events if e.kind == "user_annotation"]
    split = spans.idle_split(*spans.profiled(host_only), sp)
    assert split["idle"] == pytest.approx(100.0)
    assert sum(split[k] for k in spans.TERMS) == pytest.approx(100.0)
    assert split["harness"] == pytest.approx(10 + 10 + 5)
    assert split["launches"] == 0


def test_probe_matches_each_step_to_its_spans_on_a_drain():
    """The program's batcher with its telemetry, stepped by hand on the
    CPU: every step is one `serve/tick` tree, the pool gauges are the
    pools' own, and the readers read the record."""
    import torch

    from bench import system
    from repro_torch.obs import ServeTelemetry

    conf = {"family": "dense_decoder", "model": bench_fixture.TINY,
            "serving": {"weights": {"kind": "dense"}, "kv_dtype": "bf16",
                        "block_size": 16}}
    traffic = {"prompt_tokens": {"max": 40}, "output_tokens": {"max": 9},
               "slots": 4}
    sysm = system.build(conf, traffic, 5, torch.device("cpu"))
    b, tel = sysm.batcher, ServeTelemetry()
    b.telemetry = tel
    probe = spans.Probe(tel)
    rng = np.random.default_rng(0)
    for uid in range(9):
        b.submit(sysm.request_cls(uid=uid, prompt=rng.integers(
            0, 256, int(rng.integers(8, 40))).astype("int32"),
            max_new_tokens=int(rng.integers(3, 9))))
    r = Record(model={}, serving={}, traffic={}, n_slots=4,
               table_width=4, seconds=1.0)
    allocated, t = [], 100.0
    while b.queue or any(x is not None for x in b.slots):
        probe.before()
        b.step()
        tk = Tick(t, t + 0.1, [], [(0, 1)], 0)
        tk.program = probe.after()
        r.ticks.append(tk)
        allocated.append(sum(p.allocated_pages() for p in b.pcache.pools))
        t += 0.1
    r.t_open, r.t_close = 100.0, t
    r.spans, lost = spans.collect(tel, r.ticks)
    assert lost == 0 and len(r.spans) == tel.span_count
    assert len(spans.window_spans(r)) == len(r.ticks)
    assert spans.pages_peak(r) == max(allocated)
    syncs = sum(s.name in spans.SYNCS for s in r.spans.values())
    assert syncs == 9 + b.ticks
    assert reader("host_syncs_per_tick")(r) > 1
    usable = {p[0] + p[2] for p in spans.window_pool(r)}
    assert usable == {sum(p.n_blocks - 1 for p in b.pcache.pools)}
