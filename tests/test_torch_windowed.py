"""Two-layer-group serving of the PyTorch port against the JAX reference:
gemma3-27b smoke (6 layers, 5:1 local:global, window 8), f32 unless
stated.

At this size the stack splits into a global group (layer 5) and a
windowed group (layers 0-4) whose pages retire once they fall behind
the window. Held here:

* the config equals the reference's field by field, and both packages
  derive the same layer groups;
* paged prefill (one slot at a time, chunked with an advancing start)
  and batched decode on per-layer tables and walk starts taken from a
  live cache with retirement on: logits within 1e-4, float pools within
  1e-5, int8 codes exact and scales to f32 rounding (rtol 1e-6, see
  tests/test_torch_model.py);
* the plain K1/K2 walks from `block_start` equal the reference's Pallas
  kernels (interpret mode) on valid rows within 1e-5, single and
  bucketed by per-group live pages;
* drains equal the reference's drain of the same trace — greedy tokens,
  ticks, prefill tokens, pages allocated, pages retired per group, COW
  events, prefix hits — with retirement on and off, single-shot and
  chunked with `group_blocks="auto"`, bf16 and int8 pools;
* the long-prompt leg of `benchmarks/serve_bench.py` (bf16, as the bench
  runs it): uniform single-shot vs chunked and auto-sized, tokens
  bit-exact between the two and equal to the reference's, and the
  pinned `serve.long_prompt.{peak_resident_ratio, provisioned_ratio}`
  and the chunked drain's 20 ticks of `benchmarks/baselines.json`;
* the uniform-pool deadlock raises with the reference's per-group
  diagnostic, word for word.
"""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.paged_attention import paged_attention as j_decode_attn
from repro.kernels.paged_prefill import paged_prefill as j_prefill_attn
from repro.models import decode_step_paged as j_decode
from repro.models import init_lm as j_init_lm
from repro.models import layer_attn_groups as j_groups
from repro.models import prefill_paged as j_prefill
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import PagedKVCache as JCache
from repro.serve import Request as JRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import PORT_FIELDS, ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_prefill import paged_prefill
from repro_torch.models import (
    decode_step_paged,
    layer_attn_groups,
    prefill_paged,
)
from repro_torch.serve import ContinuousBatcher, PagedKVCache, Request

ARCH = "gemma3-27b"
LOGIT_TOL = dict(rtol=0, atol=1e-4)
POOL_TOL = dict(rtol=0, atol=1e-5)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _configs(dtype="float32"):
    return (dataclasses.replace(j_get_config(ARCH, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype))


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = _configs()
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


# ---------------------------------------------------------------------------
# config and layer groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference(smoke):
    """The reference's fields exact; the port-only ones (YaRN) at their
    defaults."""
    got = dataclasses.asdict(get_config(ARCH, smoke=smoke))
    assert {k: v for k, v in got.items() if k not in PORT_FIELDS} == \
        dataclasses.asdict(j_get_config(ARCH, smoke=smoke))
    assert all(got[k] == getattr(ModelConfig, k) for k in PORT_FIELDS)


@pytest.mark.parametrize("smoke,capacity", [(True, 40), (True, 8),
                                            (False, 3392), (False, 1024)])
def test_layer_groups_equal_reference(smoke, capacity):
    cfg, jcfg = get_config(ARCH, smoke=smoke), j_get_config(ARCH, smoke=smoke)
    groups = layer_attn_groups(cfg, capacity)
    assert groups == [(w, tuple(ls)) for w, ls in j_groups(jcfg, capacity)]
    window = cfg.sliding_window
    if capacity > window:      # one global group, then the windowed one
        assert [w for w, _ in groups] == [None, window]
        assert groups[0][1] == tuple(range(5, cfg.n_layers, 6))
    else:                      # the window covers the table: one group
        assert [w for w, _ in groups] == [None]


# ---------------------------------------------------------------------------
# paged model forward on retiring per-layer tables
# ---------------------------------------------------------------------------

BS, MAX_LEN = 4, 40


def _cache_pair(jcfg, cfg, kv_dtype):
    kw = dict(n_slots=2, max_len=MAX_LEN, block_size=BS, kv_dtype=kv_dtype)
    return JCache(jcfg, **kw), PagedKVCache(cfg, device="cpu", **kw)


def _jpools(jc):
    return [jc.k_pages, jc.v_pages] + (
        [jc.k_scales, jc.v_scales] if jc.quantized else [])


def _tpools(tc):
    return [tc.k_pages, tc.v_pages] + (
        [tc.k_scales, tc.v_scales] if tc.quantized else [])


def _set_jpools(jc, pools):
    jc.k_pages, jc.v_pages = pools[0], pools[1]
    if jc.quantized:
        jc.k_scales, jc.v_scales = pools[2], pools[3]


def _assert_pools(jc, tc):
    """Float pools within 1e-5. int8 pools: scales to f32 rounding, and
    codes exactly equal on every (layer, page, head) whose scale is
    bit-identical in both packages. Where a scale differs in its last
    bit, the two frameworks' f32 arithmetic has rounded the projected
    K/V differently (tests/test_torch_model.py), and a code whose value
    sits on a rounding boundary may land one apart. Returns the number of
    codes that differ (each by one, each under a scale that differs)."""
    names = ("k_pages", "v_pages", "k_scales", "v_scales")
    got = dict(zip(names, (x.numpy() for x in _tpools(tc))))
    want = dict(zip(names, (np.asarray(x) for x in _jpools(jc))))
    for name in got:
        assert got[name].shape == want[name].shape, name
        assert got[name].dtype == want[name].dtype, name
    if not tc.quantized:
        for name in got:
            np.testing.assert_allclose(got[name], want[name], **POOL_TOL,
                                       err_msg=name)
        return 0
    moved = 0
    for kind in ("k", "v"):
        codes, scales = kind + "_pages", kind + "_scales"
        np.testing.assert_allclose(got[scales], want[scales], rtol=1e-6,
                                   atol=0, err_msg=scales)
        same = (got[scales] == want[scales])[:, :, None, :, None]
        diff = got[codes].astype(np.int32) - want[codes].astype(np.int32)
        np.testing.assert_array_equal(np.where(same, diff, 0), 0,
                                      err_msg=codes)
        assert np.abs(diff).max() <= 1, codes
        moved += int((diff != 0).sum())
    return moved


def _views(jc, tc, rows):
    """Per-layer tables [L, B, mb] and walk starts [L, B] of `rows`, from
    each package's own cache (their host state is checked equal)."""
    jbt, jst = jc.device_block_tables(), jc.device_block_starts()
    tbt, tst = tc.device_block_tables(), tc.device_block_starts()
    np.testing.assert_array_equal(tbt.numpy(), np.asarray(jbt))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    return (jbt[:, rows], jst[:, rows], tbt[:, rows].contiguous(),
            tst[:, rows].contiguous())


def _prefill_both(models, jc, tc, slot, start, end, rng):
    jcfg, jp, cfg, tp = models
    n = end - start
    pad = -(-n // BS) * BS
    for c in (jc, tc):
        c.begin_append(slot, start, n)
    toks = np.zeros((1, pad), np.int32)
    toks[0, :n] = rng.integers(0, cfg.vocab_size, n)
    jbt, jst, tbt, tst = _views(jc, tc, [slot])
    a, b = np.asarray([start], np.int32), np.asarray([end], np.int32)
    jr = j_prefill(jp, jnp.asarray(toks), jc.k_pages, jc.v_pages, jbt,
                   jnp.asarray(a), jnp.asarray(b), jcfg,
                   last_pos=jnp.asarray(n - 1), impl="ref", block_start=jst,
                   **({"k_scales": jc.k_scales, "v_scales": jc.v_scales}
                      if jc.quantized else {}))
    tr = prefill_paged(tp, torch.tensor(toks), tc.k_pages, tc.v_pages, tbt,
                       torch.tensor(a), torch.tensor(b), cfg, last_pos=n - 1,
                       impl="auto", block_start=tst,
                       k_scales=tc.k_scales, v_scales=tc.v_scales)
    _set_jpools(jc, list(jr[1:]))
    for c in (jc, tc):
        c.lengths[slot] = end
    return jr[0], tr[0]


def _decode_both(models, jc, tc, rng):
    jcfg, jp, cfg, tp = models
    for c in (jc, tc):
        for i in range(c.n_slots):
            c.begin_append(i, int(c.lengths[i]), 1)
    toks = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    pos = np.array(tc.lengths, np.int32)
    jbt, jst, tbt, tst = _views(jc, tc, [0, 1])
    jr = j_decode(jp, jnp.asarray(toks), jc.k_pages, jc.v_pages, jbt,
                  jnp.asarray(pos), jcfg, impl="ref", block_start=jst,
                  **({"k_scales": jc.k_scales, "v_scales": jc.v_scales}
                     if jc.quantized else {}))
    tr = decode_step_paged(tp, torch.tensor(toks), tc.k_pages, tc.v_pages,
                           tbt, torch.tensor(pos), cfg, impl="auto",
                           block_start=tst, k_scales=tc.k_scales,
                           v_scales=tc.v_scales)
    _set_jpools(jc, list(jr[1:]))
    for c in (jc, tc):
        c.lengths += 1
    return jr[0], tr[0]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_and_decode_on_retiring_groups_match_reference(models,
                                                                kv_dtype):
    """The scheduler's launch pattern: slot 0 prefills 14 tokens in one
    launch, slot 1 12 tokens and then a 10-token chunk at start 12, then
    both decode 6 steps — the windowed group retires blocks along the
    way and every walk starts at the retired head."""
    rng = np.random.default_rng(5)
    jcfg, _, cfg, _ = models
    jc, tc = _cache_pair(jcfg, cfg, kv_dtype)
    steps = [lambda: _prefill_both(models, jc, tc, 0, 0, 14, rng),
             lambda: _prefill_both(models, jc, tc, 1, 0, 12, rng),
             lambda: _prefill_both(models, jc, tc, 1, 12, 22, rng)]
    steps += [lambda: _decode_both(models, jc, tc, rng)] * 6
    moved = 0
    for step in steps:
        j_logits, t_logits = step()
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   **LOGIT_TOL)
        moved += _assert_pools(jc, tc)
        if tc.quantized:
            # the next step starts from the reference's codes and scales,
            # so each step's codes are held on the same input state
            for mine, theirs in zip(_tpools(tc), _jpools(jc)):
                mine.copy_(torch.from_numpy(np.array(theirs)))
    # of ~16k codes written per step, at most a couple land one apart
    assert moved <= 2
    win = [p for p in tc.pools if p.window is not None]
    assert len(tc.pools) == 2 and len(win) == 1
    assert win[0].pages_retired > 0
    assert tc.pages_retired == win[0].pages_retired
    assert [p.pages_retired for p in tc.pools] == \
        [p.pages_retired for p in jc.pools]
    assert int(win[0].first_block.min()) > 0
    jc.check_invariants()
    tc.check_invariants()


def test_int8_append_codec_exact_on_two_groups():
    """Given the same float rows, the decode append's read-modify-write
    (dequantize the touched page, scatter the row, requantize under the
    new absmax) gives bit-identical codes and scales in both packages, on
    every layer of both groups of a retired cache."""
    from repro.kernels.paged_common import requantize_page_update as j_rq
    from repro_torch.kernels.paged_common import requantize_page_update

    cfg, tc = _retired_cache("int8", [31, 17, 6])
    gen = torch.Generator().manual_seed(9)
    pos = torch.tensor([31, 17, 6])
    for c in range(tc.n_slots):
        tc.begin_append(c, int(pos[c]), 1)
    bt = tc.device_block_tables()                      # [L, B, mb]
    rows = torch.arange(tc.n_slots)
    for l in range(cfg.n_layers):
        page = bt[l, rows, pos // BS].long()
        for codes, scales in ((tc.k_pages[l], tc.k_scales[l]),
                              (tc.v_pages[l], tc.v_scales[l])):
            new = torch.randn((tc.n_slots, cfg.n_kv_heads, cfg.hd),
                              generator=gen)

            def upd(pages_f, new=new):
                pages_f[rows, pos % BS] = new
                return pages_f

            def jupd(pages_f, new=new):
                return pages_f.at[np.arange(tc.n_slots),
                                  np.asarray(pos % BS)].set(
                    jnp.asarray(new.numpy()))

            got = requantize_page_update(codes[page], scales[page], upd)
            want = j_rq(jnp.asarray(codes[page].numpy()),
                        jnp.asarray(scales[page].numpy()), jupd)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# K1 / K2 plain walks from block_start against the reference kernels
# ---------------------------------------------------------------------------

def _retired_cache(kv_dtype, lengths, last=1):
    """A port cache whose slots have grown to `lengths` one token at a
    time and then by a final append of `last` tokens (what a decode step
    or a prefill chunk ending at the length prepares), so the windowed
    group has retired every block dead for that append's first query;
    pools hold random KV (codes and scales for int8)."""
    _, cfg = _configs()
    tc = PagedKVCache(cfg, n_slots=len(lengths), max_len=MAX_LEN,
                      block_size=BS, kv_dtype=kv_dtype, device="cpu")
    for i, n in enumerate(lengths):
        for pos in range(n - last):
            tc.begin_append(i, pos, 1)
        tc.begin_append(i, n - last, last)
        tc.lengths[i] = n
    gen = torch.Generator().manual_seed(7)
    if kv_dtype == "int8":
        for x in (tc.k_pages, tc.v_pages):
            x.copy_(torch.randint(-128, 128, x.shape, generator=gen))
        for x in (tc.k_scales, tc.v_scales):
            x.copy_(torch.rand(x.shape, generator=gen) * 0.05 + 0.01)
    else:
        for x in (tc.k_pages, tc.v_pages):
            x.copy_(torch.randn(x.shape, generator=gen))
    return cfg, tc


def _window_walk_operands(kv_dtype, lengths, last):
    """The windowed group's first layer of a `_retired_cache`: port
    operands, their numpy twins for the reference, and the group's
    bucket plan over live pages."""
    cfg, tc = _retired_cache(kv_dtype, lengths, last)
    pool = next(p for p in tc.pools if p.window is not None)
    l_win = pool.layers[0]
    bt = tc.device_block_tables()[l_win]
    st = tc.device_block_starts()[l_win]
    assert int(st.max()) > 0
    ops_t = [tc.k_pages[l_win], tc.v_pages[l_win],
             None if tc.k_scales is None else tc.k_scales[l_win],
             None if tc.v_scales is None else tc.v_scales[l_win]]
    ops_j = [None if x is None else jnp.asarray(x.numpy()) for x in ops_t]
    plans, perms = ops.plan_buckets_grouped(
        tc.bucket_needs(np.asarray(lengths)), bt.shape[1])
    assert plans is not None and plans[pool.gid] is not None
    return (cfg, bt, st, ops_t, ops_j, plans[pool.gid], perms[pool.gid])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_decode_walk_from_block_start_matches_reference_kernel(kv_dtype):
    lengths = [31, 17, 6]
    cfg, bt, st, (kp, vp, ks, vs), (jk, jv, jks, jvs), plan, perm = \
        _window_walk_operands(kv_dtype, lengths, 1)
    window = cfg.sliding_window
    gen = torch.Generator().manual_seed(8)
    q = torch.randn((len(lengths), cfg.n_heads, cfg.hd), generator=gen)
    tl = torch.tensor(lengths, dtype=torch.int32)
    want = np.asarray(j_decode_attn(
        jnp.asarray(q.numpy()), jk, jv, jnp.asarray(bt.numpy()),
        jnp.asarray(tl.numpy()), jnp.asarray(window, jnp.int32),
        impl="pallas_interpret", plan=plan, perm=jnp.asarray(perm),
        k_scales=jks, v_scales=jvs, block_start=jnp.asarray(st.numpy())))
    tperm = torch.tensor(perm, dtype=torch.int64)
    for kw in ({}, {"plan": plan, "perm": tperm}):
        got = paged_attention(q, kp, vp, bt, tl, window, impl="auto",
                              block_start=st, k_scales=ks, v_scales=vs,
                              **kw).numpy()
        np.testing.assert_allclose(got, want, **KERNEL_TOL)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_walk_from_block_start_matches_reference_kernel(kv_dtype):
    """A 6-token chunk of each slot ending at its length, padded to 8
    query rows; pad rows are don't-care."""
    lengths, n_new, t = [31, 17, 6], 6, 8
    cfg, bt, st, (kp, vp, ks, vs), (jk, jv, jks, jvs), plan, perm = \
        _window_walk_operands(kv_dtype, lengths, n_new)
    window = cfg.sliding_window
    gen = torch.Generator().manual_seed(8)
    start = torch.tensor([n - n_new for n in lengths], dtype=torch.int32)
    tl = torch.tensor(lengths, dtype=torch.int32)
    qp = torch.randn((len(lengths), t, cfg.n_heads, cfg.hd), generator=gen)
    want = np.asarray(j_prefill_attn(
        jnp.asarray(qp.numpy()), jk, jv, jnp.asarray(bt.numpy()),
        jnp.asarray(start.numpy()), jnp.asarray(tl.numpy()),
        jnp.asarray(window, jnp.int32), impl="pallas_interpret", plan=plan,
        perm=jnp.asarray(perm), k_scales=jks, v_scales=jvs,
        block_start=jnp.asarray(st.numpy())))
    valid = np.broadcast_to(np.arange(t) < n_new, (len(lengths), t))
    tperm = torch.tensor(perm, dtype=torch.int64)
    for kw in ({}, {"plan": plan, "perm": tperm}):
        got = paged_prefill(qp, kp, vp, bt, start, tl, window, impl="auto",
                            block_start=st, k_scales=ks, v_scales=vs,
                            **kw).numpy()
        np.testing.assert_allclose(got[valid], want[valid], **KERNEL_TOL)


# ---------------------------------------------------------------------------
# drains against the reference
# ---------------------------------------------------------------------------

N_SLOTS, NEW_TOKENS, SHARED = 3, 6, 8


def _trace(vocab):
    """A shared 8-token system prompt plus suffixes of 0-20 tokens (so
    most prompts cross the window of 8), and a verbatim repeat of a
    16-token prompt: a full-prefix hit whose last token recomputes into
    a shared page (the copy-on-write trigger)."""
    rng = np.random.default_rng(21)
    shared = rng.integers(0, vocab, SHARED).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, n)]).astype(
        np.int32) for n in (20, 8, 3, 14, 0, 11)]
    return prompts[:3] + [prompts[1].copy()] + prompts[3:]


def _drain(batcher_cls, request_cls, cfg, params, prompts, to_prompt,
           n_slots, cache_len, new_tokens, block_size, **kw):
    cb = batcher_cls(cfg, params, n_slots=n_slots, cache_len=cache_len,
                     paged=True, block_size=block_size, **kw)
    for uid, p in enumerate(prompts):
        cb.submit(request_cls(uid=uid, prompt=to_prompt(p),
                              max_new_tokens=new_tokens))
    res = cb.run_until_drained()
    pc = cb.pcache
    index_refs = {} if cb.prefix is None else cb.prefix.page_refs()
    stats = dict(
        ticks=cb.ticks, prefill_tokens=cb.prefill_tokens,
        decode_tokens=sum(len(v) for v in res.values()),
        pages_allocated=pc.pages_allocated, cow_events=pc.cow_events,
        retired={p.gid: p.pages_retired for p in pc.pools},
        groups=[(p.window, p.layers, p.n_blocks) for p in pc.pools],
        # no slot holds a page: every page is free or the index's
        whole=[p.n_free + len(index_refs.get(p.gid, {})) == p.n_blocks - 1
               for p in pc.pools],
        peak_resident=pc.peak_resident_page_bytes(),
        provisioned=pc.provisioned_page_bytes(),
    )
    if cb.prefix is not None:
        stats.update(hits=cb.prefix.hits,
                     cached=cb.prefix.cached_tokens_served)
    pc.check_invariants(None if cb.prefix is None
                        else cb.prefix.page_refs())
    return {u: list(v) for u, v in res.items()}, stats


def _both(jcfg, jp, cfg, tp, prompts, **kw):
    ref = _drain(JBatcher, JRequest, jcfg, jp, prompts, jnp.asarray, **kw)
    port = _drain(ContinuousBatcher, Request, cfg, tp, prompts,
                  lambda p: p, device="cpu", **kw)
    assert port[1] == ref[1]
    assert port[0] == ref[0]
    return port


DRAIN = dict(n_slots=N_SLOTS, cache_len=SHARED + 20 + NEW_TOKENS + 2,
             new_tokens=NEW_TOKENS, block_size=BS, prefix=True)


@pytest.fixture(scope="module")
def trace(models):
    return _trace(models[2].vocab_size)


@pytest.fixture(scope="module")
def single_shot(models, trace):
    return _both(*models, trace, **DRAIN)


def test_drain_single_shot_matches_reference(single_shot, trace):
    tokens, stats = single_shot
    assert len(tokens) == len(trace)
    assert all(len(v) == NEW_TOKENS for v in tokens.values())
    glob, win = stats["retired"][0], stats["retired"][1]
    assert glob == 0 and win > 0          # only the windowed group retires
    assert stats["hits"] > 0 and stats["cow_events"] > 0


@pytest.mark.parametrize("variant", [
    dict(window_retirement=False),
    dict(prefill_chunk=8, group_blocks="auto"),
    dict(prefill_chunk=8, group_blocks="auto", bucket_strategy="none"),
    dict(kv_dtype="int8"),
    dict(kv_dtype="int8", prefill_chunk=8, group_blocks="auto"),
], ids=["retire-off", "chunked-auto", "chunked-auto-nobucket", "int8",
        "int8-chunked-auto"])
def test_drain_variants_match_reference(models, trace, single_shot,
                                        variant):
    tokens, stats = _both(*models, trace, **{**DRAIN, **variant})
    if variant.get("kv_dtype") != "int8":
        # retirement and chunking never change a token
        assert tokens == single_shot[0]
    if variant.get("window_retirement") is False:
        assert stats["retired"] == {0: 0, 1: 0}
    else:
        assert stats["retired"][0] == 0 and stats["retired"][1] > 0
    if "group_blocks" in variant:
        # the windowed group is provisioned at its live bound only
        (_, _, g_blocks), (_, _, w_blocks) = stats["groups"]
        assert w_blocks < g_blocks
    assert all(stats["whole"])


# ---------------------------------------------------------------------------
# the long-prompt leg of benchmarks/serve_bench.py
# ---------------------------------------------------------------------------

LONG_LEN, SHORT_LENS, LP_NEW = 72, [6, 5, 7, 6, 4], 6


def _baseline(name):
    with open(os.path.join(REPO, "benchmarks", "baselines.json")) as f:
        return json.load(f)["metrics"][name]


@pytest.fixture(scope="module")
def long_prompt():
    """Both packages' drains of the leg: bf16 smoke weights from
    `init_lm(PRNGKey(0))`, prompts from PRNGKey(43), 2 slots, block 4;
    uniform pools single-shot, then chunk 8 with auto-sized groups."""
    jcfg, cfg = _configs(dtype="bfloat16")
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    gkey = jax.random.PRNGKey(43)
    prompts = [
        np.asarray(jax.random.randint(jax.random.fold_in(gkey, u), (t,), 0,
                                      cfg.vocab_size)).astype(np.int32)
        for u, t in enumerate([LONG_LEN] + SHORT_LENS)
    ]
    kw = dict(n_slots=2, cache_len=LONG_LEN + LP_NEW + 2, new_tokens=LP_NEW,
              block_size=BS)
    base = _both(jcfg, jp, cfg, tp, prompts, **kw)
    chunked = _both(jcfg, jp, cfg, tp, prompts, prefill_chunk=8,
                    group_blocks="auto", **kw)
    return base, chunked


def test_long_prompt_leg_reproduces_pinned_ratios(long_prompt):
    (base_tok, base), (chunk_tok, chunk) = long_prompt
    assert chunk_tok == base_tok
    peak = round(chunk["peak_resident"] / base["peak_resident"], 4)
    prov = round(chunk["provisioned"] / base["provisioned"], 4)
    assert peak == _baseline("serve.long_prompt.peak_resident_ratio") == 0.4715
    assert prov == _baseline("serve.long_prompt.provisioned_ratio") == 0.375
    assert chunk["ticks"] == _baseline("serve.long_prompt.ticks") == 20


def test_long_prompt_residency_accounting(long_prompt):
    """The accounting the ratios read, per group: the single-shot prefill
    pins the long prompt's whole windowed table at once, the chunked one
    at most the live bound."""
    (_, base), (_, chunk) = long_prompt
    assert chunk["peak_resident"] < base["peak_resident"]
    assert chunk["retired"][1] > 0 and base["retired"][1] > 0
    assert chunk["retired"][0] == base["retired"][0] == 0


# ---------------------------------------------------------------------------
# residency accessors and the deadlock diagnostic
# ---------------------------------------------------------------------------

def test_residency_accessors_match_reference():
    """`live_pages`, `allocated_pages`, `extra_refs`, `first_live_block`
    and the four byte counts, on both packages after the same sequence:
    two slots grown past the window, a third attached to slot 0's live
    pages, one slot freed."""
    jcfg, cfg = _configs()
    kw = dict(n_slots=3, max_len=MAX_LEN, block_size=BS)
    caches = [JCache(jcfg, **kw), PagedKVCache(cfg, device="cpu", **kw)]
    for c in caches:
        for i, n in ((0, 23), (1, 13)):
            for pos in range(n):
                c.begin_append(i, pos, 1)
            c.lengths[i] = n
        plan = c.plan_attach([c.slot_block_pages(0, j) for j in range(5)],
                             20)
        c.attach_chain(2, plan)
    snap = []
    for c in caches:
        snap.append((
            [[p.live_pages(s) for s in range(3)] for p in c.pools],
            [p.allocated_pages() for p in c.pools],
            [p.extra_refs() for p in c.pools],
            [[p.first_live_block(q) for q in (0, 7, 8, 11, 23)]
             for p in c.pools],
            c.resident_page_bytes(), c.peak_resident_page_bytes(),
            c.provisioned_page_bytes(), c.lockstep_equiv_page_bytes(),
        ))
        c.free_slot(1)
        snap.append((c.resident_page_bytes(), c.peak_resident_page_bytes(),
                     c.lockstep_equiv_page_bytes()))
    assert snap[2:] == snap[:2]
    (live, alloc, extra, first, res, peak, prov, lock), after = snap[2:]
    assert extra[1] > 0 and live[1][0] < live[0][0]
    assert peak >= res > after[0] and after[1] == peak
    assert lock > res


def _long_prompt_batcher(cls, request_cls, cfg, params, to_prompt, **kw):
    cb = cls(cfg, params, n_slots=2, cache_len=96, paged=True, block_size=4,
             **kw)
    rng = np.random.default_rng(11)
    for uid, t in enumerate([76, 6, 6, 6]):
        cb.submit(request_cls(
            uid=uid, prompt=to_prompt(rng.integers(0, cfg.vocab_size, t)
                                      .astype(np.int32)),
            max_new_tokens=4))
    return cb


def test_uniform_pool_deadlock_raises_with_per_group_diagnostic(models):
    """11 pages per group admit the short requests but never the long
    prompt's worst-case windowed promise; the raise names every group's
    ledger and the head-of-queue deficit, in the reference's words. With
    chunked prefill the same 11 windowed pages drain the trace."""
    jcfg, jp, cfg, tp = models
    msgs = []
    for cls, request_cls, c, p, to_prompt, kw in (
            (JBatcher, JRequest, jcfg, jp, jnp.asarray, {}),
            (ContinuousBatcher, Request, cfg, tp, lambda x: x,
             {"device": "cpu"})):
        cb = _long_prompt_batcher(cls, request_cls, c, p, to_prompt,
                                  n_blocks=12, **kw)
        with pytest.raises(RuntimeError) as ei:
            cb.run_until_drained()
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]
    assert "g0[global×1L]" in msgs[1] and "g1[w=8×5L]" in msgs[1]
    assert "head-of-queue uid=0 needs 79 tokens" in msgs[1]
    assert re.search(r"per-group draw deficit: g0:-\d+, g1:-\d+", msgs[1])
    cb = _long_prompt_batcher(ContinuousBatcher, Request, cfg, tp,
                              lambda x: x, device="cpu", prefill_chunk=8,
                              group_blocks={1: 12})
    assert len(cb.run_until_drained()) == 4


def test_launcher_gemma3_chunked_auto_on_cpu(capsys):
    """`--arch gemma3-27b` on the smoke config with chunked prefill and
    auto-sized groups: the summary lists both groups, the windowed one
    with its live bound and its window-retired pages."""
    from repro_torch.launch.serve import main as launch_main

    launch_main(["--arch", "gemma3-27b", "--paged", "--device", "cpu",
                 "--prefix", "--requests", "4", "--slots", "2",
                 "--prompt-len", "24", "--new-tokens", "4",
                 "--block-size", "4", "--prefill-chunk", "8",
                 "--group-pool", "auto"])
    out = capsys.readouterr().out
    assert "served 4 requests, 16 tokens" in out
    assert "group 0 (global, 1 layers," in out
    m = re.search(r"group 1 \(window=8, 5 layers, pool \d+ pages, "
                  r"live-bound 5 blocks/slot\): \d+ pages drawn, "
                  r"window-retired (\d+)", out)
    assert m and int(m.group(1)) > 0, out
    assert "peak resident" in out and "provisioned" in out
