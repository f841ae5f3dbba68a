"""Serving the rest of the model zoo in the port against the JAX
reference: zamba2-1.2b (Mamba2 with a shared attention block), xlstm-350m
(mLSTM / sLSTM), llava-next-34b (GQA group 7 at full width) and
whisper-medium through `init_lm`, the decoder-only stack the reference's
launcher builds for it.

Dense `ServeEngine.generate` and the dense `ContinuousBatcher` drain —
whose recurrent caches are inserted into their slots whole and whose
shared-block KV writes at the batcher's one global position, as the
reference does — for all four; the paged drains the launcher runs
(`--paged`, with and without the prefix index) for llava and whisper;
and the reference's refusal of a paged cache for the recurrent stacks.
The reference's own f32 smoke parameters cross through numpy
(`bridge.params_from_jax`). Bit-plane weights:
test_torch_families_quant.py.

Tolerance: none — greedy tokens and the drains' schedules (ticks,
prefill tokens, the dense global position, pages, prefix hits) are
EQUAL. f32 configs, as bf16 argmax near-ties flip across differently
ordered sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_lm as j_init_lm
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import (
    decode_step_paged,
    init_lm,
    init_paged_pool,
    prefill_paged,
)
from repro_torch.serve import (
    ContinuousBatcher,
    Request,
    ServeConfig,
    ServeEngine,
)

FAMILIES = ["zamba2-1.2b", "xlstm-350m", "llava-next-34b", "whisper-medium"]
N_REQUESTS, NEW_TOKENS, N_SLOTS, BLOCK = 6, 5, 3, 4


@pytest.fixture(scope="module", params=FAMILIES)
def models(request):
    jcfg = dataclasses.replace(j_get_config(request.param, smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(request.param, smoke=True),
                              dtype="float32")
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, t).astype(np.int32) for t in lens]


def _drain(batcher_cls, request_cls, cfg, params, prompts, to_prompt,
           cache_len, paged, **kw):
    cb = batcher_cls(cfg, params, n_slots=N_SLOTS, cache_len=cache_len,
                     paged=paged, block_size=BLOCK, **kw)
    for uid, p in enumerate(prompts):
        cb.submit(request_cls(uid=uid, prompt=to_prompt(p),
                              max_new_tokens=NEW_TOKENS))
    res = cb.run_until_drained()
    stats = dict(ticks=cb.ticks, prefill_tokens=cb.prefill_tokens)
    if paged:
        stats.update(pages=cb.pcache.pages_allocated,
                     hits=None if cb.prefix is None else cb.prefix.hits)
    else:
        stats.update(position=int(cb.cache["position"]))
    return {u: list(v) for u, v in res.items()}, stats


def _both(models, prompts, cache_len, paged, **kw):
    jcfg, jp, cfg, tp = models
    ref = _drain(JBatcher, JRequest, jcfg, jp, prompts, jnp.asarray,
                 cache_len, paged, **kw)
    port = _drain(ContinuousBatcher, Request, cfg, tp, prompts,
                  lambda p: p, cache_len, paged, device="cpu", **kw)
    assert port[1] == ref[1]
    assert port[0] == ref[0]
    return port


@pytest.mark.parametrize("lens", ["uniform", "ragged", "left-padded"])
def test_dense_batcher_drain_matches_reference(models, lens):
    """The dense batcher: 6 requests of 10 tokens (the launcher's shared
    prompt length), of 4..15, or of 4..15 left-padded with token 0 to 16
    (serve_bench's dense trace; the pads run through the recurrent
    state as real tokens, in both packages), 3 slots. Tokens, ticks,
    prefill tokens and the global position after the drain equal."""
    cfg = models[2]
    sizes = [10] * N_REQUESTS if lens == "uniform" else [4, 15, 7, 12, 5, 9]
    prompts = _prompts(cfg.vocab_size, sizes, 1)
    if lens == "left-padded":
        prompts = [np.pad(p, (16 - len(p), 0)) for p in prompts]
    tokens, stats = _both(models, prompts, 16 + NEW_TOKENS, paged=False)
    assert sum(map(len, tokens.values())) == N_REQUESTS * NEW_TOKENS
    assert stats["position"] == stats["ticks"]


def test_dense_generate_matches_reference(models):
    """Dense `generate` of 3 prompts of 9 tokens, 6 new: tokens equal."""
    jcfg, jp, cfg, tp = models
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 9)).astype(np.int32)
    sc = dict(max_cache_len=20, max_new_tokens=6)
    ref = JEngine(jcfg, jp, JServeConfig(**sc)).generate(jnp.asarray(prompts))
    port = ServeEngine(cfg, tp, ServeConfig(device="cpu", **sc)).generate(
        prompts)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("prefix", [False, True])
def test_paged_drain_matches_reference_or_is_refused(models, prefix):
    """The launcher's `--paged` drain (ragged prompts, with and without
    the prefix index over a shared 8-token system prompt): for llava and
    whisper tokens and schedule equal; for zamba2 and xlstm both
    packages refuse the paged cache with the same ValueError."""
    jcfg, jp, cfg, tp = models
    prompts = _prompts(cfg.vocab_size, [4, 15, 7, 12, 5, 9], 3)
    if prefix:
        shared = np.arange(3, 11, dtype=np.int32)
        prompts = [np.concatenate([shared, p]) for p in prompts]
    cache_len = 8 + 16 + NEW_TOKENS
    if cfg.block_kind != "attn":
        msg = f"paged KV cache requires attention layers, got {cfg.block_kind}"
        with pytest.raises(ValueError, match=msg):
            JBatcher(jcfg, jp, n_slots=N_SLOTS, cache_len=cache_len,
                     paged=True, block_size=BLOCK, prefix=prefix)
        with pytest.raises(ValueError, match=msg):
            ContinuousBatcher(cfg, tp, n_slots=N_SLOTS, cache_len=cache_len,
                              paged=True, block_size=BLOCK, prefix=prefix,
                              device="cpu")
        return
    tokens, stats = _both(models, prompts, cache_len, paged=True,
                          prefix=prefix)
    assert not prefix or stats["hits"] > 0


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_recurrent_stacks_refuse_the_paged_entry_points(arch):
    """`ServeEngine(paged=True).generate`, the page pools and both paged
    entry points raise the reference's ValueErrors."""
    cfg = get_config(arch, smoke=True)
    params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(cfg, params, ServeConfig(paged=True, device="cpu",
                                               max_cache_len=16))
    got = f"paged KV cache requires attention layers, got {cfg.block_kind}"
    with pytest.raises(ValueError, match=got):
        eng.generate(np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError, match=got):
        init_paged_pool(cfg, 4, 4, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError,
                       match="decode_step_paged supports attention stacks"):
        decode_step_paged(params, tok, None, None, None, None, cfg)
    with pytest.raises(ValueError,
                       match="prefill_paged supports attention stacks"):
        prefill_paged(params, tok, None, None, None, None, None, cfg)
