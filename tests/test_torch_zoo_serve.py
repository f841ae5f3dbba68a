"""Serving the rest of the attention model zoo in the port against the
JAX reference: qwen2.5-14b, granite-20b (MQA, plain GELU MLP),
phi3.5-moe-42b-a6.6b and llama4-scout-17b-a16e (mixtures of experts,
whose rows of one step compete for the experts' places, so a drain is
equal only if every step presents the same rows in the same order).

Drains of `benchmarks/serve_bench.py`'s paged trace (8 ragged requests
of 4-16 tokens, 6 new tokens, 3 slots, block 4) through both packages'
`ContinuousBatcher`, paged (with the prefix index, int8 KV pools and
chunked prefill) and dense, and `ServeEngine.generate`, paged and
dense. The reference's own f32 smoke parameters cross through numpy
(`bridge.params_from_jax`). Bit-plane weights: test_torch_zoo_quant.py.

Tolerance: none — greedy tokens and the drains' schedules (ticks,
prefill tokens, pages, COW events, prefix hits) are EQUAL. f32 configs,
as bf16 argmax near-ties flip across differently ordered sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import init_lm as j_init_lm
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.serve import (
    ContinuousBatcher,
    Request,
    ServeConfig,
    ServeEngine,
)

ZOO = ["qwen2.5-14b", "granite-20b", "phi3.5-moe-42b-a6.6b",
       "llama4-scout-17b-a16e"]
N_REQUESTS, MAX_PROMPT, NEW_TOKENS, N_SLOTS, BLOCK = 8, 16, 6, 3, 4


@pytest.fixture(scope="module", params=ZOO)
def models(request):
    jcfg = dataclasses.replace(j_get_config(request.param, smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(request.param, smoke=True),
                              dtype="float32")
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


def _trace(vocab):
    """`benchmarks/serve_bench.py::_trace`: lengths 4..16, PRNGKey(42)."""
    key = jax.random.PRNGKey(42)
    lens = [
        4 + int(jax.random.randint(jax.random.fold_in(key, 500 + u), (), 0,
                                   max(MAX_PROMPT - 3, 1)))
        for u in range(N_REQUESTS)
    ]
    return [
        np.asarray(jax.random.randint(jax.random.fold_in(key, u), (t,), 0,
                                      vocab)).astype(np.int32)
        for u, t in enumerate(lens)
    ]


def _drain(batcher_cls, request_cls, cfg, params, prompts, to_prompt,
           cache_len, paged, **kw):
    cb = batcher_cls(cfg, params, n_slots=N_SLOTS, cache_len=cache_len,
                     paged=paged, block_size=BLOCK, **kw)
    for uid, p in enumerate(prompts):
        cb.submit(request_cls(uid=uid, prompt=to_prompt(p),
                              max_new_tokens=NEW_TOKENS))
    res = cb.run_until_drained()
    stats = dict(ticks=cb.ticks, prefill_tokens=cb.prefill_tokens,
                 decode_tokens=sum(len(v) for v in res.values()))
    if paged:
        pc = cb.pcache
        stats.update(pages_allocated=pc.pages_allocated,
                     cow_events=pc.cow_events)
        if cb.prefix is not None:
            stats.update(hits=cb.prefix.hits,
                         cached=cb.prefix.cached_tokens_served)
        pc.check_invariants(None if cb.prefix is None
                            else cb.prefix.page_refs())
    return {u: list(v) for u, v in res.items()}, stats


def _both(models, prompts, cache_len, paged=True, **kw):
    jcfg, jp, cfg, tp = models
    ref = _drain(JBatcher, JRequest, jcfg, jp, prompts, jnp.asarray,
                 cache_len, paged, **kw)
    port = _drain(ContinuousBatcher, Request, cfg, tp, prompts,
                  lambda p: p, cache_len, paged, device="cpu", **kw)
    assert port[1] == ref[1]
    assert port[0] == ref[0]
    return port


@pytest.mark.parametrize("mode", ["single-shot", "prefix", "int8-kv",
                                  "chunked"])
def test_paged_drain_matches_reference(models, mode):
    """Paged drains: single-shot; every prompt opening with a shared
    8-token system prompt (prefix hits, suffix prefill from start > 0);
    int8 KV pools; 8-token prefill chunks. Tokens and schedule equal."""
    trace = _trace(models[2].vocab_size)
    cache_len = MAX_PROMPT + NEW_TOKENS + 2
    kw = {}
    if mode == "prefix":
        shared = np.arange(3, 11, dtype=np.int32)
        trace = [np.concatenate([shared, p]) for p in trace]
        cache_len += 8
        kw = dict(prefix=True)
    elif mode == "int8-kv":
        kw = dict(kv_dtype="int8")
    elif mode == "chunked":
        kw = dict(prefill_chunk=8)
    tokens, stats = _both(models, trace, cache_len, **kw)
    assert stats["decode_tokens"] == N_REQUESTS * NEW_TOKENS
    if mode == "prefix":
        assert stats["hits"] > 0 and stats["cached"] > 0


def test_dense_batcher_drain_matches_reference(models):
    """The dense-cache batcher's drain: tokens and schedule equal."""
    tokens, stats = _both(models, _trace(models[2].vocab_size),
                          MAX_PROMPT + NEW_TOKENS + 2, paged=False)
    assert stats["decode_tokens"] == N_REQUESTS * NEW_TOKENS


@pytest.mark.parametrize("paged", [True, False])
def test_engine_generate_matches_reference(models, paged):
    """`generate`, dense and paged (single-shot, 4-token chunks, int8
    KV): tokens equal."""
    jcfg, jp, cfg, tp = models
    prompts = np.random.default_rng(3).integers(0, 128, (3, 10)).astype(
        np.int32)
    extra = ({}, {"prefill_chunk": 4}, {"kv_dtype": "int8"}) if paged \
        else ({},)
    for kw in extra:
        sc = dict(max_cache_len=32, max_new_tokens=6, paged=paged,
                  block_size=4, **kw)
        ref = JEngine(jcfg, jp, JServeConfig(**sc)).generate(
            jnp.asarray(prompts))
        port = ServeEngine(cfg, tp, ServeConfig(device="cpu", **sc)).generate(
            prompts)
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))

