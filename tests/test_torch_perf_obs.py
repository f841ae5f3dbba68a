"""The port's perf model (`repro_torch.obs.perf`) against the reference's
(`repro.obs.perf`), on hypothesis-drawn needs and pool geometry.

The CPU builds no bucket plans in a drain (the plain version has no
walk to bound), so this is where bucketed plans are held on the CPU: the
predictions are asked for a launch on a CUDA device, which needs no
card — only the impl rule reads the device. The reference's plans are
switched on with its interpreted Pallas impl, the port's with `auto`
(or `cuda`) on `"cuda"`.

Compared exactly: `plan_signature`, `plans_enabled` (also against the
port's own dispatch gate `ops._bucketing_off`), `predict_streamed_pages`,
every field of `predict_launch`'s `LaunchPrediction` and its roofline
time, and, after the same `PerfModel.record_launch` calls, both
registries' summaries and `perf.summary()` with both models priced at
the H100. `CompileWatcher`: the same `on_compile` calls give the same
registry and summary when the reference's executable reports no cost
analysis (the port never has one).
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import tpu_gold as j_gold
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import perf as jperf
from repro_torch.core import H100_SXM
from repro_torch.kernels import ops
from repro_torch.obs import MetricsRegistry, ManualClock
from repro_torch.obs import perf

J_H100 = j_gold.ChipSpec(**dataclasses.asdict(H100_SXM))

#: (port impl, port device) -> the reference impl with the same plan rule
IMPL_PAIRS = (
    ("ref", "cpu", "ref"),
    ("ref", "cuda", "ref"),
    ("auto", "cpu", "auto"),          # the reference's auto is ref off-TPU
    ("auto", "cuda", "pallas_interpret"),
    ("cuda", "cuda", "pallas_interpret"),
)

_PLAN = st.lists(st.tuples(st.integers(1, 64), st.integers(1, 16)),
                 min_size=1, max_size=4).map(
    lambda p: tuple((int(b), int(c)) for b, c in p))


@settings(max_examples=60, deadline=None)
@given(plans=st.one_of(st.none(), _PLAN,
                       st.lists(st.one_of(st.none(), _PLAN), min_size=1,
                                max_size=3).map(tuple)))
def test_plan_signature_equals_reference(plans):
    assert perf.plan_signature(plans) == jperf.plan_signature(plans)


@pytest.mark.parametrize("strategy", ["pow2", "none"])
@pytest.mark.parametrize("impl,device,ref_impl", IMPL_PAIRS)
def test_plans_enabled_equals_gate_and_reference(strategy, impl, device,
                                                 ref_impl):
    got = perf.plans_enabled(strategy, impl, device)
    assert got == (not ops._bucketing_off(strategy, impl, device))
    assert got == jperf.plans_enabled(strategy, ref_impl)


def test_plans_enabled_strict_cuda_on_cpu_raises():
    with pytest.raises(RuntimeError, match="impl='cuda'"):
        perf.plans_enabled("pow2", "cuda", "cpu")


@settings(max_examples=80, deadline=None)
@given(needs=st.lists(st.integers(1, 40), min_size=1, max_size=12),
       width=st.integers(1, 40), bucketed=st.booleans())
def test_predict_streamed_pages_equals_reference(needs, width, bucketed):
    needs = [min(n, width) for n in needs]
    n = len(needs)
    got = perf.predict_streamed_pages(needs, n, width, bucketed=bucketed)
    assert got == jperf.predict_streamed_pages(needs, n, width,
                                               bucketed=bucketed)
    if bucketed:
        plan, _ = ops.make_bucket_plan(None, 0, width, needs=needs)
        assert got == ops.plan_streamed_pages(plan, n, width)


@dataclasses.dataclass
class _Pool:
    gid: int
    layers: tuple


class _Geometry:
    """What `predict_launch` reads of a cache: the groups' layer counts,
    the table width, the page-layer bytes, and the per-group live needs
    of the launch (`bucket_needs`), given here directly."""

    def __init__(self, layers_by_group, width, plb, needs, device):
        self.pools = [_Pool(g, tuple(range(n)))
                      for g, n in enumerate(layers_by_group)]
        self.max_blocks_per_slot = width
        self.page_layer_bytes = plb
        self._needs = needs
        self.device = device

    def bucket_needs(self, eff_lengths, slots=None):
        return [np.asarray(n) for n in self._needs]


_GEOMETRY = st.integers(1, 3).flatmap(lambda g: st.tuples(
    st.lists(st.integers(1, 12), min_size=g, max_size=g),
    st.integers(1, 32),
    st.sampled_from([512, 1024, 65664, 131072]),
    st.integers(1, 9),
)).flatmap(lambda geo: st.tuples(
    st.just(geo),
    st.lists(st.lists(st.integers(1, geo[1]), min_size=geo[3],
                      max_size=geo[3]),
             min_size=len(geo[0]), max_size=len(geo[0])),
))


def _measured(geo, plans_on):
    """The dispatch's own accounting of the launch: the plans
    `bucket_args_grouped` would build, walked per group."""
    (layers, width, plb, n_rows), needs = geo
    plans = (ops.plan_buckets_grouped(needs, width)[0] if plans_on
             else None)
    pages = ops.grouped_streamed_pages(plans, n_rows, width, len(layers))
    return plans, pages, [n * pg * plb for n, pg in zip(layers, pages)]


@settings(max_examples=60, deadline=None)
@given(geo=_GEOMETRY, pair=st.sampled_from(IMPL_PAIRS),
       strategy=st.sampled_from(["pow2", "none"]))
def test_predict_launch_equals_reference(geo, pair, strategy):
    (layers, width, plb, n_rows), needs = geo
    impl, device, ref_impl = pair
    cache = _Geometry(layers, width, plb, needs, device)
    eff = np.arange(1, n_rows + 1)
    got = perf.predict_launch(cache, eff, None, n_rows, strategy=strategy,
                              kernel_impl=impl)
    ref = jperf.predict_launch(cache, eff, None, n_rows, strategy=strategy,
                               kernel_impl=ref_impl)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.bytes_total == ref.bytes_total
    assert got.roofline_s() == ref.roofline_s(J_H100)
    assert got.roofline_s() == got.bytes_total / 3.35e12


@settings(max_examples=30, deadline=None)
@given(launches=st.lists(st.tuples(_GEOMETRY, st.sampled_from(
    ["decode", "prefill"])), min_size=1, max_size=6),
    pair=st.sampled_from(IMPL_PAIRS))
def test_record_launch_equals_reference(launches, pair):
    impl, device, ref_impl = pair
    reg, jreg = MetricsRegistry(clock=ManualClock()), JRegistry()
    model = perf.PerfModel(reg)
    jmodel = jperf.PerfModel(jreg, J_H100)
    plans_on = perf.plans_enabled("pow2", impl, device)
    for geo, phase in launches:
        (layers, width, plb, n_rows), needs = geo
        cache = _Geometry(layers, width, plb, needs, device)
        plans, pages, nbytes = _measured(geo, plans_on)
        eff = np.arange(1, n_rows + 1)
        got = model.record_launch(phase, cache, plans, n_rows, eff, None,
                                  "pow2", impl, pages, nbytes)
        ref = jmodel.record_launch(phase, cache, plans, n_rows, eff, None,
                                   "pow2", ref_impl, pages, nbytes)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert reg.summary() == jreg.summary()
    assert reg.prometheus() == jreg.prometheus()
    assert model.summary() == jmodel.summary()
    assert model.launch_log == jmodel.launch_log
    # the dispatch's accounting is what the model predicts, plans or not
    assert model.summary()["model_error_max"] == 0.0


def test_model_error_records_drift():
    """A measured launch that streams what the model does not predict
    lands in a nonzero error bucket, per phase and per group."""
    reg = MetricsRegistry()
    model = perf.PerfModel(reg)
    cache = _Geometry([2], 8, 1024, [[1, 3]], "cuda")
    model.record_launch("decode", cache, None, 2, [1, 9], None, "pow2",
                        "auto", [16], [2 * 16 * 1024])
    pred = perf.predict_launch(cache, [1, 9], None, 2, kernel_impl="auto")
    assert pred.pages_by_group == [5]                 # 1x1 + 4x1
    err = abs(pred.bytes_total - 2 * 16 * 1024) / (2 * 16 * 1024)
    assert model.summary()["model_error_max"] == err > 0
    h = reg.histogram("perf_model_error", {"phase": "decode", "group": 0},
                      bounds=perf.MODEL_ERROR_BUCKETS)
    assert h.count == 1 and h.counts[0] == 0


class _NoCost:
    def cost_analysis(self):
        return None


def test_compile_watcher_equals_reference():
    reg, jreg = MetricsRegistry(clock=ManualClock()), JRegistry(
        clock=ManualClock())
    w, jw = perf.CompileWatcher(reg), jperf.CompileWatcher(jreg, J_H100)
    for step, plans, wall in (("decode", ((2, 1),), 0.5),
                              ("decode", (((2, 1),), None), 0.25),
                              ("prefill", None, 0.1)):
        w.on_compile(step, plans, wall)
        jw.on_compile(step, plans, wall, _NoCost())
    assert reg.summary() == jreg.summary()
    assert w.summary() == jw.summary()
    assert w.by_step() == {"decode": 2, "prefill": 1}
    assert all(c["hlo_flops"] == c["hlo_bytes"] == 0.0
               for c in w.summary()["compiles"])
    assert w.clock() == 0.0
