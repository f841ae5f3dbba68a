"""Serving telemetry of the PyTorch port against the JAX reference.

* Registry and event log: the same operations on `repro_torch.obs` and
  `repro.obs` give the same `summary()`, `prometheus()` and events, and
  the port renders `tests/golden/prometheus_snapshot.txt` byte for byte.
* Drains: the f32 qwen2-1.5b smoke model (one layer group) and the f32
  gemma3-27b smoke model (a global and a window-8 group that retires
  pages) drain the same ragged trace through both packages' batchers —
  the reference with `kernel_impl="ref"`, the port on `device="cpu"` —
  each with a `ServeTelemetry` on a `ManualClock` advanced by one second
  after every tick. The event stream (names and every field, timestamps
  included), every counter, gauge and histogram, the per-tick streamed
  bytes and occupancy, `latency_summary()`, `perf.summary()` and the
  recompile counts by step are equal. Left out: the
  `serve_compiled_hlo_{flops,bytes}` gauges and the compile records'
  `hlo_*` / `compute_s` / `memory_s` fields, which the reference fills
  from XLA's cost analysis of each compiled step while the port, which
  compiles nothing, reports 0.
* Contracts held inside the port: `mutation_count()` stays flat across a
  drain with telemetry off, the deadlock event is structured, the H100
  spec's constants are pinned, `roofline_terms` equals the reference's
  for the same spec, the profiler ranges of `profile=True`, and the
  launcher's `--metrics` / `--events-out`.

Tolerance: exact everywhere — integers, and host floats computed from
the same clock readings by the same arithmetic.
"""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import obs as jobs
from repro.configs import get_config as j_get_config
from repro.core import tpu_gold as j_gold
from repro.models import init_lm as j_init_lm
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JEngine
from repro_torch import obs
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import H100_SXM, ChipSpec, roofline_terms
from repro_torch.kernels import paged_common
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import (
    ContinuousBatcher,
    Request,
    ServeConfig,
    ServeEngine,
)
from repro_torch.serve.compiled import trace_count

GOLDEN = pathlib.Path(__file__).parent / "golden" / "prometheus_snapshot.txt"
#: the reference's ChipSpec carrying the port's H100 figures, so both
#: perf models price launches at the same card
J_H100 = j_gold.ChipSpec(**dataclasses.asdict(H100_SXM))
#: what the reference fills from XLA's cost analysis and the port, which
#: compiles nothing, reports as 0
HLO_GAUGES = ("serve_compiled_hlo_flops", "serve_compiled_hlo_bytes")
HLO_FIELDS = ("hlo_flops", "hlo_bytes", "compute_s", "memory_s")


# ---------------------------------------------------------------------------
# registry, event log, facade
# ---------------------------------------------------------------------------

def _golden_registry(pkg):
    """The operations of `tests/test_obs.py::_golden_registry`."""
    r = pkg.MetricsRegistry(clock=pkg.ManualClock())
    r.counter("serve_ticks", help="scheduler ticks elapsed").inc(3)
    r.counter(
        "serve_recompiles_total",
        {"step": "decode", "plans": 'geo "pow2"\nw\\2x1+4x1'},
        help="XLA compiles by step kind x plan signature",
    ).inc(2)
    r.gauge("pool_occupancy", {"zeta": "z", "alpha": "a"}).set(0.5)
    h = r.histogram("serve_ttft_s", bounds=(0.1, 1.0),
                    help="time to first token (s)")
    for v in (0.05, 1.0, 5.0):
        h.observe(v)
    return r


def test_prometheus_golden_snapshot_byte_for_byte():
    text = _golden_registry(obs).prometheus()
    assert text == GOLDEN.read_text()
    assert text == _golden_registry(jobs).prometheus()
    assert (_golden_registry(obs).summary()
            == _golden_registry(jobs).summary())


_OP = st.tuples(
    st.sampled_from(["counter", "gauge", "histogram", "event"]),
    st.sampled_from(["serve_a", "pool_b", "kernel_c"]),
    st.sampled_from([None, {"group": 0}, {"kind": "decode", "group": 1},
                     {"plans": 'a"b\\c\nd'}]),
    st.floats(0.0, 300.0, allow_nan=False, allow_infinity=False),
)


def _apply_ops(pkg, ops, tmp_path=None):
    clk = pkg.ManualClock(0.0, tick=0.125)
    r = pkg.MetricsRegistry(clock=clk)
    path = None if tmp_path is None else str(tmp_path)
    log = pkg.EventLog(path=path, clock=clk)
    for kind, name, labels, v in ops:
        # one metric kind per name, as the registry requires
        name = f"{name}_{kind}"
        if kind == "counter":
            r.counter(name, labels, help=f"{name} help").inc(int(v))
        elif kind == "gauge":
            r.gauge(name, labels).set(v)
        elif kind == "histogram":
            r.histogram(name, labels,
                        bounds=pkg.exponential_buckets(0.5, 2.0, 6)
                        ).observe(v)
        else:
            log.emit(name, value=v, labels=labels)
        clk.advance(v / 100.0)
    log.close()
    return r, log


@settings(max_examples=40, deadline=None)
@given(ops=st.lists(_OP, max_size=30))
def test_registry_and_events_equal_reference(ops):
    before = obs.mutation_count()
    r, log = _apply_ops(obs, ops)
    jr, jlog = _apply_ops(jobs, ops)
    assert r.summary() == jr.summary()
    assert r.prometheus() == jr.prometheus()
    assert log.events == jlog.events and log.counts() == jlog.counts()
    n_mut = sum(k != "event" for k, *_ in ops)
    assert obs.mutation_count() - before == n_mut


def test_event_log_file_equals_reference(tmp_path):
    ops = [("event", "serve_a", {"kind": "decode", "group": 1}, 3.0),
           ("counter", "pool_b", None, 2.0),
           ("event", "kernel_c", None, 1.5)]
    _apply_ops(obs, ops, tmp_path / "port.jsonl")
    _apply_ops(jobs, ops, tmp_path / "ref.jsonl")
    port = (tmp_path / "port.jsonl").read_text()
    assert port == (tmp_path / "ref.jsonl").read_text()
    assert json.loads(port.splitlines()[-1])["event"] == obs.RUN_END


def _play(tel, trace):
    """`tests/test_obs.py::_play`: each entry is (prompt_tokens,
    n_decode_events)."""
    for uid, (pt, _) in enumerate(trace):
        tel.on_submit(uid, pt, 16)
    for uid, (pt, nd) in enumerate(trace):
        tel.on_admit(uid, slot=0, cached_tokens=pt // 3)
        tel.on_prefill(uid, pt)
        tel.on_first_token(uid)
        for _ in range(nd):
            tel.on_decode([uid])
        tel.on_finish(uid)
        tel.end_tick(queued=len(trace) - uid - 1, active=0)


@settings(max_examples=25, deadline=None)
@given(trace=st.lists(st.tuples(st.integers(1, 64), st.integers(0, 6)),
                      min_size=1, max_size=12))
def test_facade_replay_equals_reference(trace):
    tels = []
    for pkg in (obs, jobs):
        clk = pkg.ManualClock(0.0, tick=0.125)
        tel = pkg.ServeTelemetry(clock=clk)
        _play(tel, trace)
        tel.close()
        tels.append(tel)
    port, ref = tels
    assert port.summary() == ref.summary()
    assert port.events.events == ref.events.events
    assert port.latency_summary() == ref.latency_summary()


# ---------------------------------------------------------------------------
# drains against the reference
# ---------------------------------------------------------------------------

N_SLOTS, BLOCK, NEW_TOKENS, SHARED = 3, 4, 6, 8


@pytest.fixture(scope="module", params=["qwen2-1.5b", "gemma3-27b"])
def models(request):
    jcfg = dataclasses.replace(j_get_config(request.param, smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(request.param, smoke=True),
                              dtype="float32")
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


def _trace(vocab, n=7, lo=4, hi=24, seed=5):
    """Ragged prompts behind a shared 8-token system prompt; on gemma3
    (window 8) every prompt crosses the window."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, SHARED).astype(np.int32)
    return [np.concatenate([shared, rng.integers(
        0, vocab, int(rng.integers(lo, hi + 1))).astype(np.int32)])
        for _ in range(n)]


def _telemetry_drain(batcher_cls, request_cls, tel_cls, clock_cls, cfg,
                     params, prompts, to_prompt, **kw):
    clk = clock_cls()
    tel = tel_cls(clock=clk, chip=kw.pop("chip", None))
    cb = batcher_cls(cfg, params, n_slots=N_SLOTS,
                     cache_len=SHARED + 24 + NEW_TOKENS + 2, paged=True,
                     block_size=BLOCK, telemetry=tel, **kw)
    for uid, p in enumerate(prompts):
        cb.submit(request_cls(uid=uid, prompt=to_prompt(p),
                              max_new_tokens=NEW_TOKENS))
    res = cb.run_until_drained(on_tick=lambda _: clk.advance(1.0))
    tel.close()
    return {u: list(v) for u, v in res.items()}, tel, cb


def _comparable(tel):
    """Everything the two packages must agree on, with the cost-analysis
    fields left out (module docstring)."""
    summary = tel.summary()
    summary["metrics"] = {k: v for k, v in summary["metrics"].items()
                          if not k.startswith(HLO_GAUGES)}
    rec = summary.pop("recompiles")
    rec["compiles"] = [{k: v for k, v in c.items() if k not in HLO_FIELDS}
                       for c in rec["compiles"]]
    prom = [ln for ln in tel.registry.prometheus().splitlines()
            if "serve_compiled_hlo_" not in ln]
    return dict(summary=summary, recompiles=rec, prometheus=prom,
                events=tel.events.events,
                tick_occupancy=tel.tick_occupancy,
                latency=tel.latency_summary(),
                perf=tel.perf.summary())


def _both(models, prompts, **kw):
    jcfg, jp, cfg, tp = models
    ref = _telemetry_drain(JBatcher, JRequest, jobs.ServeTelemetry,
                           jobs.ManualClock, jcfg, jp, prompts, jnp.asarray,
                           kernel_impl="ref", chip=J_H100, **kw)
    port = _telemetry_drain(ContinuousBatcher, Request, obs.ServeTelemetry,
                            obs.ManualClock, cfg, tp, prompts, lambda p: p,
                            device="cpu", **kw)
    assert port[0] == ref[0]
    a, b = _comparable(port[1]), _comparable(ref[1])
    for key in a:
        assert a[key] == b[key], key
    return port


DRAIN_CASES = {
    "qwen2-1.5b": [dict(prefix=True),
                   dict(kv_dtype="int8", prefill_chunk=8)],
    "gemma3-27b": [dict(prefix=True, prefill_chunk=8, group_blocks="auto"),
                   dict(prefix=True, prefill_chunk=8, group_blocks="auto",
                        kv_dtype="int8")],
}


@pytest.mark.parametrize("case", [0, 1])
def test_drain_telemetry_equals_reference(models, case):
    cfg = models[2]
    kw = DRAIN_CASES[cfg.name][case]
    tokens, tel, cb = _both(models, _trace(cfg.vocab_size), **kw)
    r = tel.registry
    assert tel.perf.summary()["model_error_max"] == 0.0
    # serve_ticks counts every step; `ticks` skips a step whose only work
    # was admitting a chunked prefill's first chunk (both packages)
    if kw.get("prefill_chunk"):
        assert r.counter("serve_ticks").value >= cb.ticks
    else:
        assert r.counter("serve_ticks").value == cb.ticks
    assert r.counter("serve_prefill_tokens").value == cb.prefill_tokens
    assert r.counter("serve_requests_finished").value == len(tokens)
    assert (len(tel.events.of("first_token"))
            + r.counter("serve_decode_tokens").value
            == sum(map(len, tokens.values())))
    assert sum(tel.tick_streamed_bytes) == tel.streamed_bytes_total
    if kw.get("prefix"):
        assert r.gauge("pool_prefix_hits").value == cb.prefix.hits > 0
    if cfg.name == "gemma3-27b":
        retired = [r.gauge("pool_pages_retired", {"group": g}).value
                   for g in (0, 1)]
        assert retired[0] == 0 and retired[1] > 0
        assert retired == [p.pages_retired for p in cb.pcache.pools]


def test_engine_telemetry_equals_reference(models):
    """`ServeEngine.generate` with telemetry, twice on one engine (fresh
    uids per call), on a clock that moves on every read."""
    jcfg, jp, cfg, tp = models
    prompts = np.random.default_rng(3).integers(0, 128, (3, 10)).astype(
        np.int32)
    sc = dict(max_cache_len=32, max_new_tokens=6, paged=True, block_size=4,
              prefill_chunk=4)
    jtel = jobs.ServeTelemetry(clock=jobs.ManualClock(0.0, tick=0.25),
                               chip=J_H100)
    ttel = obs.ServeTelemetry(clock=obs.ManualClock(0.0, tick=0.25))
    jeng = JEngine(jcfg, jp, JServeConfig(kernel_impl="ref", **sc),
                   telemetry=jtel)
    teng = ServeEngine(cfg, tp, ServeConfig(device="cpu", **sc),
                       telemetry=ttel)
    for _ in range(2):
        ref = jeng.generate(jnp.asarray(prompts))
        port = teng.generate(prompts)
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    for tel in (jtel, ttel):
        tel.close()
    a, b = _comparable(ttel), _comparable(jtel)
    for key in a:
        assert a[key] == b[key], key
    assert ttel.lifecycle_counts() == {"submitted": 6, "finished": 6}
    assert ttel.perf.summary()["model_error_max"] == 0.0


# ---------------------------------------------------------------------------
# contracts held inside the port
# ---------------------------------------------------------------------------

def _port_drain(cfg, params, prompts, telemetry=None, **kw):
    cb = ContinuousBatcher(cfg, params, n_slots=N_SLOTS,
                           cache_len=SHARED + 24 + NEW_TOKENS + 2,
                           paged=True, block_size=BLOCK, device="cpu",
                           telemetry=telemetry, **kw)
    for uid, p in enumerate(prompts):
        cb.submit(Request(uid=uid, prompt=p, max_new_tokens=NEW_TOKENS))
    return cb.run_until_drained(), cb


def test_metrics_off_drain_touches_no_metric(models):
    """telemetry=None: no inc/set/observe anywhere in the process during
    the drain, and the tokens equal a telemetry-on drain's."""
    cfg, tp = models[2], models[3]
    prompts = _trace(cfg.vocab_size, n=4)
    before = obs.mutation_count()
    off, _ = _port_drain(cfg, tp, prompts, prefix=True)
    assert obs.mutation_count() == before
    tel = obs.ServeTelemetry(clock=obs.ManualClock())
    t0 = trace_count()
    on, cb = _port_drain(cfg, tp, prompts, telemetry=tel, prefix=True)
    assert on == off
    assert obs.mutation_count() > before
    # every step signature of the telemetry drain reached the watcher
    assert tel.compile_watcher().total == trace_count() - t0
    assert tel.compile_watcher().by_step() == {
        "decode": cb._decode_paged.cache_size(),
        "prefill": cb._prefill_paged.cache_size()}


def test_deadlock_event_is_structured_and_equals_reference(models):
    jcfg, jp, cfg, tp = models
    evs = []
    for batcher_cls, req_cls, pkg, c, p, kw, to_prompt in (
            (JBatcher, JRequest, jobs, jcfg, jp, {}, jnp.asarray),
            (ContinuousBatcher, Request, obs, cfg, tp, {"device": "cpu"},
             lambda x: x)):
        tel = pkg.ServeTelemetry(clock=pkg.ManualClock(0.0, tick=0.001))
        cb = batcher_cls(c, p, n_slots=1, cache_len=16, paged=True,
                         block_size=4, telemetry=tel, **kw)
        pc = cb.pcache
        for pool in pc.pools:
            while pool.n_free > 1:
                pool._ref[pool.free_blocks.popleft()] = 1
        cb.submit(req_cls(uid=0, prompt=to_prompt(
            np.arange(8, dtype=np.int32)), max_new_tokens=4))
        with pytest.raises(RuntimeError, match="deadlock at tick 1.*pools:"):
            cb.run_until_drained()
        evs.append(tel.events.of("deadlock"))
    (ref,), (port,) = evs
    assert port == ref
    assert port["tick"] == 1 and port["queued"] == 1
    assert port["free_by_group"] == {
        str(g): 1 for g in range(len(cb.pcache.pools))}


def test_h100_spec_pinned():
    assert H100_SXM == ChipSpec(
        name="h100-sxm", peak_flops_bf16=989e12, hbm_bandwidth=3.35e12,
        hbm_capacity=80e9, ici_bandwidth=50e9, ici_links=18,
        vmem_bytes=228 * 1024)
    assert H100_SXM.ici_bandwidth * H100_SXM.ici_links == 900e9
    assert obs.ServeTelemetry().chip is H100_SXM
    assert obs.PerfModel(obs.MetricsRegistry()).chip is H100_SXM
    assert not hasattr(obs.perf, "TPU_V5E")


@pytest.mark.parametrize("spec", ["tpu-v5e", "h100-sxm"])
@pytest.mark.parametrize("cell", [
    ("decode", 1, 2.0e9, 4.0e9, 0.0, 1.5e9, 0.0),
    ("train", 8, 9.0e15, 3.0e11, 5.0e10, 6.0e16, 1.0e9),
    ("empty", 4, 0.0, 0.0, 0.0, 0.0, 0.0),
])
def test_roofline_terms_equal_reference(spec, cell):
    """The same spec on both sides. The reference prices
    `roofline_fraction` at the v5e peak whatever the spec; the port at
    its spec's — so that one field is compared for the v5e spec only."""
    if spec == "tpu-v5e":
        jspec = j_gold.TPU_V5E
        tspec = ChipSpec(**dataclasses.asdict(jspec))
    else:
        tspec, jspec = H100_SXM, J_H100
    name, chips, fl, by, coll, model, per_dev = cell
    port = roofline_terms(name, chips, fl, by, coll, model, chip=tspec,
                          bytes_per_device=per_dev).as_dict()
    ref = j_gold.roofline_terms(name, chips, fl, by, coll, model,
                                chip=jspec,
                                bytes_per_device=per_dev).as_dict()
    if spec == "h100-sxm":
        port.pop("roofline_fraction"), ref.pop("roofline_fraction")
    np.testing.assert_equal(port, ref)
    assert tspec.flops_per_byte == jspec.flops_per_byte


def _profiled_ranges(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    names = {}
    for e in prof.events():
        names[e.name] = names.get(e.name, 0) + 1
    return names


def test_profile_annotations_name_every_step(models):
    """`profile=True`: one `serve/paged_decode` range per decode launch
    and one `serve/paged_prefill` range per prefill launch."""
    cfg, tp = models[2], models[3]
    tel = obs.ServeTelemetry(clock=obs.ManualClock(), profile=True)
    names = _profiled_ranges(lambda: _port_drain(
        cfg, tp, _trace(cfg.vocab_size, n=4), telemetry=tel, prefix=True))
    launches = tel.registry.counter
    assert names.get("serve/paged_decode") == launches(
        "kernel_launches", {"kind": "decode"}).value > 0
    assert names.get("serve/paged_prefill") == launches(
        "kernel_launches", {"kind": "prefill"}).value > 0
    off = _profiled_ranges(lambda: _port_drain(
        cfg, tp, _trace(cfg.vocab_size, n=2)))
    assert not any(n.startswith("serve/paged_") for n in off)


def test_bucket_ranges_only_inside_annotated_steps():
    """Each bucket launch is a `paged_bucket_d{bound}x{count}` range
    inside `bucket_scopes()` and opens no range outside it."""
    plan = ((2, 2), (4, 1))
    perm = torch.tensor([0, 2, 1])
    table = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    lens = torch.tensor([3, 9, 2], dtype=torch.int32)

    def launch(depth, bt, ln):
        return bt[:, :depth].sum(dim=1, keepdim=True) + ln[:, None]

    def dispatch():
        return paged_common.bucketed_page_dispatch(launch, plan, perm,
                                                   table, [lens])

    def annotated():
        with paged_common.bucket_scopes():
            out = dispatch()
        return out

    names = _profiled_ranges(annotated)
    assert names.get("paged_bucket_d2x2") == 1
    assert names.get("paged_bucket_d4x1") == 1
    assert not any(n.startswith("paged_bucket")
                   for n in _profiled_ranges(dispatch))
    assert torch.equal(annotated(), dispatch())


def test_launcher_metrics_block_and_event_log(tmp_path, capsys):
    path = tmp_path / "events.jsonl"
    launch_serve.main(["--paged", "--device", "cpu", "--prefix",
                       "--requests", "4", "--new-tokens", "4", "--metrics",
                       "--events-out", str(path)])
    out = capsys.readouterr().out
    for line in ("  telemetry:", "    ttft_s: p50=", "    tpot_s: p50=",
                 "    queue_delay_s: p50=", "    kernel streamed bytes: ",
                 "  perf attribution (chip=h100-sxm):",
                 "err_max=0 ", "    recompiles: ",
                 "  --- prometheus snapshot ---",
                 "serve_requests_finished 4",
                 f"  events written to {path}"):
        assert line in out, line
    events = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert events[-1]["event"] == obs.RUN_END
    assert [e["seq"] for e in events] == list(range(len(events)))
    assert events[-1]["events"] == len(events) - 1
    by_type = {}
    for e in events[:-1]:
        by_type[e["event"]] = by_type.get(e["event"], 0) + 1
    assert events[-1]["by_type"] == by_type
    assert by_type["submit"] == by_type["finish"] == 4


def test_launcher_profile_annotations_imply_metrics(capsys):
    launch_serve.main(["--paged", "--device", "cpu", "--requests", "2",
                       "--new-tokens", "2", "--profile-annotations"])
    assert "  --- prometheus snapshot ---" in capsys.readouterr().out
