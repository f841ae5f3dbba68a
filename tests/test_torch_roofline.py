"""The port's roofline (`repro_torch.launch.roofline`) against the
reference's, on the CPU.

* The closed forms (`count_tree_params`, `active_matmul_params`,
  `model_flops_for_cell`, `analytic_bytes_for_cell`, `count_tree_bytes`)
  equal the reference's to 1e-12 relative on every `ARCH_IDS` x `SHAPES`
  cell `shape_applicable` admits, dense and 8-bit quantized, over each
  package's abstract trees; `shape_applicable`'s skips and reasons are
  equal.
* Counted FLOPs of qwen2-1.5b smoke f32 dense prefill, decode and train
  steps equal the reference's `HloAnalysis(compiled.as_text()).flops` for
  the same jitted steps within 1%. No term differs by design: both count
  the dot products (every score block of the dense attention, the
  recompute and backward of the train step) and nothing else.
* A paged and a pim8 step on `impl="ref"` report the kernels' formulas
  (K1/K2: 4 hd H per visible pair; K3/K4: 2 B K M), the aten ops the
  plain routes run inside a dispatch are not counted (the count splits
  `FlopCounterMode`'s total exactly), and the count does not change when
  the plain version is replaced by another implementation.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro.configs import ARCH_IDS, SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import shape_applicable as j_shape_applicable
from repro.launch import roofline as JR
from repro.launch import specs as JS
from repro.launch.roofline import HloAnalysis
from repro.models import decode_step as j_decode_step
from repro.models import init_lm as j_init_lm
from repro.models import prefill as j_prefill
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.train import make_train_step as j_make_train_step
from repro_torch.analysis.dispatch_lint import probe_config, probe_steps
from repro_torch.bridge import params_from_jax
from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.kernels import ref, work
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as S
from repro_torch.models import decode_step, init_lm, prefill
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.quant import PimQuantConfig, quantize_tree
from repro_torch.train.step import make_train_step

REL = 1e-12


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "pim8"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_closed_forms_equal_the_reference(arch, quantized):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jp = JS.abstract_params(jcfg, quantized=quantized)
    tp = S.abstract_params(cfg, quantized=quantized)
    for name, jshape in J_SHAPES.items():
        shape = SHAPES[name]
        assert shape_applicable(cfg, shape) == j_shape_applicable(jcfg,
                                                                  jshape)
        if not shape_applicable(cfg, shape)[0]:
            continue
        pairs = [
            (R.count_tree_params(tp), JR.count_tree_params(jp)),
            (R.count_tree_bytes(tp), JR.count_tree_bytes(jp)),
            (R.active_matmul_params(cfg, tp),
             JR.active_matmul_params(jcfg, jp)),
            (R.model_flops_for_cell(cfg, shape, tp),
             JR.model_flops_for_cell(jcfg, jshape, jp)),
            (R.analytic_bytes_for_cell(cfg, shape, tp),
             JR.analytic_bytes_for_cell(jcfg, jshape, jp)),
        ]
        for got, want in pairs:
            assert abs(got - want) <= REL * abs(want), (name, got, want)


def test_skips_and_reasons_equal_the_reference():
    got = {(a, s): shape_applicable(get_config(a), SHAPES[s])
           for a in ARCH_IDS for s in SHAPES}
    want = {(a, s): j_shape_applicable(j_get_config(a), J_SHAPES[s])
            for a in ARCH_IDS for s in J_SHAPES}
    assert got == want
    assert sum(not ok for ok, _ in got.values()) > 0


# ---------------------------------------------------------------------------
# counted FLOPs against the reference's HLO count
# ---------------------------------------------------------------------------

B, T, CACHE = 2, 16, 24


@pytest.fixture(scope="module")
def qwen2_f32():
    jcfg = dataclasses.replace(j_get_config("qwen2-1.5b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype="float32")
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu",
                         dtype=torch.float32)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    return jcfg, jp, cfg, tp, toks


def _hlo_flops(fn, *args) -> float:
    return HloAnalysis(jax.jit(fn).lower(*args).compile().as_text()).flops


def _close(got, want):
    assert want > 0 and abs(got - want) <= 0.01 * want, (got, want)


def test_prefill_flops_equal_hlo(qwen2_f32):
    jcfg, jp, cfg, tp, toks = qwen2_f32
    want = _hlo_flops(lambda p, t: j_prefill(p, t, jcfg, CACHE), jp,
                      jnp.asarray(toks))
    _, count = R.count_step(lambda: prefill(tp, torch.tensor(toks), cfg,
                                            CACHE))
    assert count["kernel_flops"] == 0
    _close(count["flops"], want)


def test_decode_flops_equal_hlo(qwen2_f32):
    jcfg, jp, cfg, tp, toks = qwen2_f32
    _, jcache = j_prefill(jp, jnp.asarray(toks), jcfg, CACHE)
    _, cache = prefill(tp, torch.tensor(toks), cfg, CACHE)
    tok = np.zeros((B, 1), np.int32)
    want = _hlo_flops(lambda p, t, c: j_decode_step(p, t, c, jcfg), jp,
                      jnp.asarray(tok), jcache)
    _, count = R.count_step(lambda: decode_step(tp, torch.tensor(tok), cache,
                                                cfg))
    _close(count["flops"], want)


def test_train_flops_equal_hlo(qwen2_f32):
    jcfg, jp, cfg, tp, toks = qwen2_f32
    batch = {"tokens": toks, "targets": toks}
    want = _hlo_flops(j_make_train_step(jcfg, JAdamWConfig()), jp,
                      j_adamw_init(jp),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(cfg, AdamWConfig())
    _, count = R.count_step(lambda: step(
        tp, adamw_init(tp), {k: torch.tensor(v) for k, v in batch.items()}))
    _close(count["flops"], want)


# ---------------------------------------------------------------------------
# kernel work at the dispatch points
# ---------------------------------------------------------------------------

class _Inside(TorchDispatchMode):
    """FLOPs of the registry's ops run inside an open kernel dispatch."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        f = flop_registry.get(func._overloadpacket)
        if f is not None and work.inside():
            self.flops += float(f(*args, **kwargs, out_val=out))
        return out


def _probe(quantized=False):
    cfg = probe_config()
    params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    if quantized:
        params = quantize_tree(params, PimQuantConfig(
            n_bits=8, group=1, impl="ref", min_features=1))
    return cfg, params


def _steps(cfg, params):
    return {name: fn for name, fn, _ in probe_steps(
        cfg, params, torch.device("cpu"), impl="ref", lengths=(9, 3),
        prompt=9, cached=4)}


@pytest.mark.parametrize("name", ["decode", "prefill"])
def test_paged_step_reports_the_kernel_formula(name):
    cfg, params = _probe()
    fn = _steps(cfg, params)[name]
    _, count = R.count_step(fn)
    kernel = {"decode": "paged_decode", "prefill": "paged_prefill"}[name]
    got = count["kernels"][kernel]
    hd, h = cfg.hd, cfg.n_heads
    windows = cfg.window_schedule(16)
    if name == "decode":
        # the decode step writes position len and attends len + 1 keys
        pairs = [sum(min(n + 1, w) for n in (9, 3)) for w in windows]
    else:
        pairs = [sum(min(p + 1, w) for p in range(4, 13)) for w in windows]
    assert got["calls"] == cfg.n_layers
    assert got["flops"] == sum(4.0 * hd * h * p for p in pairs)
    assert got["bytes"] > 0


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "pim8"])
@pytest.mark.parametrize("name", ["decode", "prefill"])
def test_plain_routes_are_not_counted_twice(name, quantized):
    """The count splits `FlopCounterMode`'s total: ours (outside the
    dispatches) + the plain versions' own ops (inside) = all of it."""
    cfg, params = _probe(quantized)
    fn = _steps(cfg, params)[name]
    _, count = R.count_step(fn)
    fn = _steps(cfg, params)[name]
    with FlopCounterMode(display=False) as total, work.KernelScopes(), \
            _Inside() as inside:
        fn()
    assert count["aten_flops"] + inside.flops == total.get_total_flops()
    assert inside.flops > 0
    if quantized:
        k3 = count["kernels"]["bitplane_gemv"]
        assert k3["calls"] > 0 and k3["flops"] > 0


def test_count_is_the_same_whatever_implements_the_kernel(monkeypatch):
    cfg, params = _probe(quantized=True)
    base = R.count_step(_steps(cfg, params)["decode"])[1]
    slow_attn = ref.paged_attention_ref

    def twice(*a, **k):
        slow_attn(*a, **k)
        return slow_attn(*a, **k)
    monkeypatch.setattr(ref, "paged_attention_ref", twice)
    other = R.count_step(_steps(cfg, params)["decode"])[1]
    for key in ("flops", "aten_flops", "kernel_flops", "kernel_bytes"):
        assert other[key] == base[key], key


def test_bitplane_work_formula():
    x = torch.zeros((3, 5, 16))
    planes = torch.zeros((8, 2, 7), dtype=torch.uint8)
    scale = torch.zeros((7,))
    flops, nbytes = work.bitplane_work(x, planes, scale)
    assert flops == 2 * 15 * 16 * 7
    assert nbytes == 8 * 2 * 7 + 7 * 4 + x.numel() * 4 + 15 * 7 * 4


def test_analyze_step_terms_and_detail():
    cfg, params = _probe()
    fn = _steps(cfg, params)["decode"]
    terms, detail = R.analyze_step("probe|decode", fn, 1, 1e6,
                                   analytic_bytes=R.unkerneled_param_bytes(
                                       params), kernel_bytes=True)
    assert terms.hlo_flops == detail["counted_flops"]["aten"] + \
        detail["counted_flops"]["kernels"]
    assert terms.hlo_bytes == detail["analytic_bytes_per_device"] + \
        detail["kernel_bytes"]
    assert terms.collective_bytes == 0 and detail["collectives_by_kind"] == {}
    assert terms.peak_flops == R.H100_SXM.peak_flops_bf16
    sh = R.shares(terms, 2 * terms.bound_s)
    assert sh["bound_share"] == pytest.approx(0.5)
