"""Dense (non-paged) serving of the PyTorch port against the JAX reference,
on the CPU.

Inputs come from a numpy seed; model parameters are the reference's own
`init_lm` draws crossed through numpy (`bridge.params_from_jax`); every
model runs in f32 (greedy tokens of bf16 smoke models flip on argmax
near-ties between differently compiled paths).

* Attention: `_gqa_core` with and without a mask; `_chunked_gqa` causal
  and windowed at T = S = 1536, where `_pick_block(1536, 1024)` halves
  to 512; `_full_seq_attention` at T = S = 1448 (dense, 2,096,704 score
  elements <= 2^21) and 1449 (chunked); `attention_decode` at positions
  inside the cache and at and past its end, where the reference's
  `dynamic_update_slice` clamps the write to the last row while RoPE and
  the mask take the unclamped position. Outputs within atol 1e-5.
* Model: `forward`, `prefill` (with and without `last_pos`) and decode
  steps running past the cache's end, for qwen2-1.5b and gemma3-27b
  smoke (window 8). Logits within atol 1e-4 and caches within 1e-5, the
  bars of `tests/test_torch_model.py`; positions equal.
* `ServeEngine.generate` (dense): tokens equal the reference's with
  dense weights and with bit-plane weights (8-bit g 1, 4-bit g 2), and
  with decode steps past `max_cache_len`.
* serve_bench's dense drain (`benchmarks/serve_bench.py::_trace`: 8
  requests, 3 slots, cache_len 24, prompts left-padded to 16, 6 new
  tokens): tokens, ticks 15, prefill tokens 128, decode tokens 48 and
  the batcher's global position after every tick (1..15) equal the
  reference's; with a `ServeTelemetry` on a `ManualClock`, its events,
  counters, latency summary and step-signature counts by step kind
  equal the reference's too (exact).
* The launcher without `--paged` serves from the dense cache.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.serve_bench import _trace as serve_bench_trace
from repro import obs as jobs
from repro.configs import get_config as j_get_config
from repro.core import tpu_gold as j_gold
from repro.models import attention as jattn
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_lm as j_init_lm
from repro.models import prefill as j_prefill
from repro.quant.bitplane import PimQuantConfig as JQuantConfig
from repro.quant.bitplane import quantize_tree as j_quantize_tree
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JEngine
from repro_torch import obs
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import H100_SXM
from repro_torch.launch.serve import main as launch_main
from repro_torch.models import attention as tattn
from repro_torch.models import decode_step, forward, prefill
from repro_torch.quant import PimQuantConfig, quantize_tree
from repro_torch.serve import (
    ContinuousBatcher,
    Request,
    ServeConfig,
    ServeEngine,
)

ATTN_TOL = dict(rtol=0, atol=1e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
CACHE_TOL = dict(rtol=0, atol=1e-5)
J_H100 = j_gold.ChipSpec(**dataclasses.asdict(H100_SXM))
HLO_GAUGES = ("serve_compiled_hlo_flops", "serve_compiled_hlo_bytes")
HLO_FIELDS = ("hlo_flops", "hlo_bytes", "compute_s", "memory_s")


def _both(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.tensor(a)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_gqa_core(masked):
    rng = np.random.default_rng(0)
    jq, tq = _both(rng, (2, 5, 4, 8))
    jk, tk = _both(rng, (2, 7, 2, 8))
    jv, tv = _both(rng, (2, 7, 2, 8))
    jm = tm = None
    if masked:
        ok = rng.random((2, 5, 7)) < 0.7
        ok[..., 0] = True
        m = np.where(ok, 0.0, -1e30).astype(np.float32)
        jm, tm = jnp.asarray(m), torch.tensor(m)
    _close(tattn._gqa_core(tq, tk, tv, tm), jattn._gqa_core(jq, jk, jv, jm),
           ATTN_TOL)


def test_pick_block_halves_like_the_reference():
    for n, target in ((1536, 1024), (1536, 512), (1449, 512), (24, 1024)):
        assert tattn._pick_block(n, target) == jattn._pick_block(n, target)
    assert tattn._pick_block(1536, 1024) == 512
    assert (tattn.Q_BLOCK, tattn.KV_BLOCK, tattn.DENSE_SCORE_LIMIT) == (
        jattn.Q_BLOCK, jattn.KV_BLOCK, jattn.DENSE_SCORE_LIMIT)


@pytest.mark.parametrize("window", [None, 300])
def test_chunked_gqa_where_the_block_halves(window):
    rng = np.random.default_rng(1)
    t = 1536
    jq, tq = _both(rng, (1, t, 4, 8))
    jk, tk = _both(rng, (1, t, 2, 8))
    jv, tv = _both(rng, (1, t, 2, 8))
    jpos, tpos = jnp.arange(t, dtype=jnp.int32), torch.arange(t)
    _close(tattn._chunked_gqa(tq, tk, tv, tpos, tpos, window, True),
           jattn._chunked_gqa(jq, jk, jv, jpos, jpos, window, True),
           ATTN_TOL)


@pytest.mark.parametrize("t", [1448, 1449])
def test_full_seq_attention_both_sides_of_the_dense_limit(t):
    rng = np.random.default_rng(2)
    jq, tq = _both(rng, (1, t, 2, 8))
    jk, tk = _both(rng, (1, t, 1, 8))
    jv, tv = _both(rng, (1, t, 1, 8))
    jpos, tpos = jnp.arange(t, dtype=jnp.int32), torch.arange(t)
    assert (t * t <= tattn.DENSE_SCORE_LIMIT) == (t == 1448)
    _close(tattn._full_seq_attention(tq, tk, tv, tpos, tpos, 64, True),
           jattn._full_seq_attention(jq, jk, jv, jpos, jpos, 64, True),
           ATTN_TOL)


def _attn_params(rng, d, h, kv, hd):
    """Projections at the init's fan-in scale (std 1/sqrt(fan_in)), so
    outputs are O(1) as in the model; unit-normal biases."""
    shapes = dict(wq=(d, h * hd), wk=(d, kv * hd), wv=(d, kv * hd),
                  wo=(h * hd, d), bq=(h * hd,), bk=(kv * hd,), bv=(kv * hd,))
    jp, tp = {}, {}
    for name, shape in shapes.items():
        a = rng.standard_normal(shape).astype(np.float32)
        if len(shape) == 2:
            a /= np.float32(np.sqrt(shape[0]))
        jp[name], tp[name] = jnp.asarray(a), torch.tensor(a)
    return jp, tp


@pytest.mark.parametrize("position", [3, 7, 8, 11])
@pytest.mark.parametrize("window", [None, 3])
def test_attention_decode_clamps_its_write_like_the_reference(position,
                                                              window):
    """S = 8: position 7 is the last row; 8 and 11 write there too (JAX
    clamps the update's start), with RoPE and the mask at 8 and 11."""
    rng = np.random.default_rng(3)
    d, h, kv, hd, s = 16, 4, 2, 8, 8
    jp, tp = _attn_params(rng, d, h, kv, hd)
    jx, tx = _both(rng, (2, 1, d))
    jck, tck = _both(rng, (2, s, kv, hd))
    jcv, tcv = _both(rng, (2, s, kv, hd))
    kw = dict(n_heads=h, n_kv_heads=kv, head_dim=hd, rope_theta=10000.0,
              window=window)
    jout, jck, jcv = jattn.attention_decode(
        jp, jx, jnp.asarray(position, jnp.int32), jck, jcv, **kw)
    tout, tck2, tcv2 = tattn.attention_decode(tp, tx, position, tck, tcv,
                                              **kw)
    assert tck2 is tck                    # written in place
    _close(tout, jout, ATTN_TOL)
    _close(tck, jck, ATTN_TOL)
    _close(tcv, jcv, ATTN_TOL)


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

ARCHS = ["qwen2-1.5b", "gemma3-27b"]


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg = dataclasses.replace(j_get_config(request.param, smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(request.param, smoke=True),
                              dtype="float32")
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


def _tokens(vocab, shape, seed):
    t = np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)
    return jnp.asarray(t), torch.tensor(t)


def _assert_cache(tcache, jcache):
    assert tcache["position"] == int(jcache["position"])
    for key in ("k", "v"):
        assert tcache[key].shape == jcache[key].shape
        _close(tcache[key], jcache[key], CACHE_TOL)


def test_forward_logits_match(models):
    jcfg, jp, cfg, tp = models
    jt, tt = _tokens(cfg.vocab_size, (2, 12), 4)
    jlog, jaux = j_forward(jp, jt, jcfg)
    tlog, taux = forward(tp, tt, cfg)
    _close(tlog, jlog, LOGIT_TOL)
    assert float(taux["moe_aux"]) == float(jaux["moe_aux"]) == 0.0


@pytest.mark.parametrize("last_pos", [None, 4])
def test_prefill_and_decode_steps_match(models, last_pos):
    """Prompt 10 in a cache of 12: decode steps at positions 10, 11 (the
    last row), then 12 and 13, which the reference clamps onto row 11."""
    jcfg, jp, cfg, tp = models
    jt, tt = _tokens(cfg.vocab_size, (2, 10), 5)
    jlog, jcache = j_prefill(jp, jt, jcfg, 12, last_pos=last_pos)
    tlog, tcache = prefill(tp, tt, cfg, 12, last_pos=last_pos)
    _close(tlog, jlog, LOGIT_TOL)
    _assert_cache(tcache, jcache)
    for step in range(4):
        jtok, ttok = _tokens(cfg.vocab_size, (2, 1), 6 + step)
        jlog, jcache = j_decode(jp, jtok, jcache, jcfg)
        tlog, tcache = decode_step(tp, ttok, tcache, cfg)
        _close(tlog, jlog, LOGIT_TOL)
        _assert_cache(tcache, jcache)
    assert tcache["position"] == 14


# ---------------------------------------------------------------------------
# ServeEngine.generate
# ---------------------------------------------------------------------------

_QUANT = {}


def _weights(models, fmt):
    """Dense f32 weights, or both packages' bit-plane trees of them."""
    jcfg, jp, cfg, tp = models
    if fmt is None:
        return jp, tp
    key = (cfg.name, fmt)
    if key not in _QUANT:
        n_bits, group = fmt
        _QUANT[key] = (
            j_quantize_tree(jp, JQuantConfig(n_bits, group, min_features=1)),
            quantize_tree(tp, PimQuantConfig(n_bits, group, min_features=1)),
        )
    return _QUANT[key]


@pytest.mark.parametrize("fmt", [None, (8, 1), (4, 2)],
                         ids=["dense", "pim8g1", "pim4g2"])
def test_generate_tokens_match(models, fmt):
    jcfg, _, cfg, _ = models
    jw, tw = _weights(models, fmt)
    jt, tt = _tokens(cfg.vocab_size, (3, 9), 7)
    sc = dict(max_cache_len=16, max_new_tokens=6)
    ref = JEngine(jcfg, jw, JServeConfig(**sc)).generate(jt)
    port = ServeEngine(cfg, tw, ServeConfig(device="cpu", **sc)).generate(tt)
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_generate_past_the_cache_end_matches(models):
    """T + max_new_tokens > max_cache_len: the last decode steps write
    clamped onto the cache's last row, as the reference's do."""
    jcfg, jp, cfg, tp = models
    jt, tt = _tokens(cfg.vocab_size, (2, 6), 8)
    sc = dict(max_cache_len=8, max_new_tokens=6)
    ref = JEngine(jcfg, jp, JServeConfig(**sc)).generate(jt)
    port = ServeEngine(cfg, tp, ServeConfig(device="cpu", **sc)).generate(tt)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# serve_bench's dense drain
# ---------------------------------------------------------------------------

BENCH = dict(n_requests=8, max_prompt=16, new_tokens=6, n_slots=3)


def _bench_drain(batcher_cls, request_cls, cfg, params, prompts, to_prompt,
                 position, telemetry=None, clock=None, **kw):
    """The dense drain of `benchmarks/serve_bench.py` (prompts left-padded
    to 16), stepped one tick at a time to read the global position."""
    n = BENCH["max_prompt"]
    cb = batcher_cls(cfg, params, n_slots=BENCH["n_slots"],
                     cache_len=n + BENCH["new_tokens"] + 2, prompt_len=n,
                     paged=False, telemetry=telemetry, **kw)
    for uid, p in enumerate(prompts):
        p = np.pad(p, (n - p.shape[0], 0))
        cb.submit(request_cls(uid=uid, prompt=to_prompt(p),
                              max_new_tokens=BENCH["new_tokens"]))
    positions = []
    while cb.queue or any(s is not None for s in cb.slots):
        cb.step()
        positions.append(position(cb.cache))
        if clock is not None:
            clock.advance(1.0)
    if telemetry is not None:
        telemetry.close()
    return dict(tokens={u: list(v) for u, v in cb.finished.items()},
                ticks=cb.ticks, prefill_tokens=cb.prefill_tokens,
                decode_tokens=sum(map(len, cb.finished.values())),
                positions=positions)


@pytest.fixture(scope="module")
def qwen2():
    jcfg = dataclasses.replace(j_get_config("qwen2-1.5b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype="float32")
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    _, prompts = serve_bench_trace(jcfg, BENCH["n_requests"],
                                   BENCH["max_prompt"])
    return jcfg, jp, cfg, tp, [np.asarray(p) for p in prompts]


def _comparable(tel):
    """What both packages' telemetry must agree on, without the fields
    the reference fills from XLA's cost analysis."""
    summary = tel.summary()
    summary["metrics"] = {k: v for k, v in summary["metrics"].items()
                          if not k.startswith(HLO_GAUGES)}
    rec = summary.pop("recompiles")
    rec["compiles"] = [{k: v for k, v in c.items() if k not in HLO_FIELDS}
                       for c in rec["compiles"]]
    prom = [ln for ln in tel.registry.prometheus().splitlines()
            if "serve_compiled_hlo_" not in ln]
    return dict(summary=summary, recompiles=rec, prometheus=prom,
                events=tel.events.events, latency=tel.latency_summary())


@pytest.mark.parametrize("with_telemetry", [False, True],
                         ids=["off", "telemetry"])
def test_serve_bench_dense_drain_matches(qwen2, with_telemetry):
    jcfg, jp, cfg, tp, prompts = qwen2
    jtel = ttel = jclk = tclk = None
    if with_telemetry:
        jclk, tclk = jobs.ManualClock(), obs.ManualClock()
        jtel = jobs.ServeTelemetry(clock=jclk, chip=J_H100)
        ttel = obs.ServeTelemetry(clock=tclk)
    before = obs.mutation_count()
    ref = _bench_drain(JBatcher, JRequest, jcfg, jp, prompts, jnp.asarray,
                       lambda c: int(c["position"]), jtel, jclk)
    port = _bench_drain(ContinuousBatcher, Request, cfg, tp, prompts,
                        lambda p: p, lambda c: c["position"], ttel, tclk,
                        device="cpu")
    assert port == ref
    assert (port["ticks"], port["prefill_tokens"], port["decode_tokens"]) \
        == (15, 128, 48)
    assert port["positions"] == list(range(1, 16))
    if not with_telemetry:
        return
    a, b = _comparable(ttel), _comparable(jtel)
    for key in a:
        assert a[key] == b[key], key
    assert ttel.compile_watcher().by_step() == {"dense_decode": 1,
                                                "dense_prefill": 1}
    assert obs.mutation_count() > before


def test_dense_drain_without_telemetry_touches_no_metric(qwen2):
    _, _, cfg, tp, prompts = qwen2
    before = obs.mutation_count()
    cb = ContinuousBatcher(cfg, tp, n_slots=2, cache_len=24, prompt_len=16,
                           device="cpu")
    for uid, p in enumerate(prompts[:3]):
        cb.submit(Request(uid=uid, prompt=np.pad(p, (16 - len(p), 0)),
                          max_new_tokens=3))
    assert len(cb.run_until_drained()) == 3
    assert obs.mutation_count() == before


def test_launcher_serves_the_dense_cache_by_default(capsys):
    launch_main(["--device", "cpu", "--requests", "3", "--slots", "2",
                 "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "dense cache" in out and "served 3 requests, 9 tokens" in out
    assert "prefill tokens processed: 48" in out
