"""Paged serving of the PyTorch port against the JAX reference.

* Differential test of `PagedKVCache` + `PrefixIndex`: the same random
  sequence of reserve, attach, begin_append (COW), free, publish and
  evict drives both packages; tables, free lists, refcounts, the
  `_drawn`/`_reserved` ledgers, the index's page references and the
  pool contents stay equal, and `check_invariants` holds on both after
  every step.
* Drains of `benchmarks/serve_bench.py`'s paged trace (8 ragged requests
  of 4-16 tokens, 6 new tokens, 3 slots, block 4) through the port's
  `ContinuousBatcher(paged=True, device="cpu")` and the reference's:
  tokens, ticks, prefill tokens, pages allocated and COW events are
  equal, also with the prefix index, int8 KV pools and chunked prefill
  (whose tokens also equal the single-shot ones). The pinned ticks (15)
  and decode tokens (48) of benchmarks/baselines.json hold. Its pinned
  prefill_tokens (72) does not: the trace's lengths come from
  `jax.random`, whose bits differ under the installed JAX, and the
  reference's own drain of this trace prefills 96 padded tokens — the
  sum of its lengths rounded up to whole blocks, which is what both
  packages are held to here.

* EOS emitted at prefill (the case of the reference's
  `test_batcher_eos_stops_slot_and_frees_pages`): the port's drain equals
  the reference's step by step, and the freed slot is refilled the same
  tick.

Tokens are compared on the f32 smoke config: bf16 argmax near-ties flip
across differently ordered sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as j_get_config
from repro.models import init_lm as j_init_lm
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import PagedKVCache as JCache
from repro.serve import PrefixIndex as JIndex
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.obs import ServeTelemetry
from repro_torch.serve import (
    ContinuousBatcher,
    PagedKVCache,
    PrefixIndex,
    Request,
    ServeConfig,
    ServeEngine,
)
from repro_torch.serve.compiled import trace_count


@pytest.fixture(scope="module", params=["qwen2-1.5b", "gemma3-27b"])
def models(request):
    """One global layer group (qwen2) and two, one of them windowed
    (gemma3: window 8, whose pages retire on these traces)."""
    jcfg = dataclasses.replace(j_get_config(request.param, smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(request.param, smoke=True),
                              dtype="float32")
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


# ---------------------------------------------------------------------------
# differential test: cache + prefix index bookkeeping
# ---------------------------------------------------------------------------

def _cache_state(cache, index):
    pools = []
    for p in cache.pools:
        pools.append((
            p.block_table.tolist(), p.first_block.tolist(),
            list(p.free_blocks), dict(p._ref),
            {s: r for s, r in p._reserved.items()},
            {s: d for s, d in p._drawn.items() if d or s in p._reserved},
            p.pages_allocated, p.cow_events, p.pages_retired,
            [list(o) for o in p._owned],
        ))
    return (pools, cache.lengths.tolist(), index.page_refs(),
            dict(index.retained_by_group), len(index), index.evicted_pages)


def _admit(cache, index, slot, prompt, n_new):
    """The scheduler's admission sequence for one request, against either
    package's cache/index: lookup, attach plan, reservation, attach,
    suffix append (COW of a shared last page), publish."""
    t = len(prompt)
    total = t + n_new - 1
    keys = index.block_keys(prompt)
    chain = index.lookup_chain(prompt, keys=keys)
    n_cached, cow = index.split_prompt(prompt, chain)
    plan = None
    if n_cached:
        nbh = -(-n_cached // cache.block_size)
        plan = cache.plan_attach([n.pages for n in chain[:nbh]], n_cached)
    if plan is not None and n_cached:
        shared, n_cow = cache.attach_plan_counts(plan, cow)
    else:
        plan, shared, n_cow, n_cached = None, 0, 0, 0
    if not cache.reserve_slot(slot, total, n_shared=shared, n_cow=n_cow):
        return cache.reserve_deficits(total, shared, n_cow)
    if plan is not None:
        cache.attach_chain(slot, plan)
    cache.begin_append(slot, n_cached, t - n_cached)
    cache.lengths[slot] = t
    index.publish(prompt, cache, slot, keys=keys)
    return None


def _apply(op, cache, index, budget):
    kind, slot, arg = op
    if kind == "admit":
        if cache.owned_blocks(slot):
            return
        prompt, n_new = arg
        deficit = _admit(cache, index, slot, prompt, n_new)
        if deficit is None:
            budget[slot] = len(prompt) + n_new - 1
    elif kind == "append":
        if cache.owned_blocks(slot) and cache.lengths[slot] < budget[slot]:
            cache.begin_append(slot, int(cache.lengths[slot]), 1)
            cache.lengths[slot] += 1
    elif kind == "free":
        cache.free_slot(slot)
        budget[slot] = 0
    elif kind == "evict":
        index.evict(cache, arg)


def _ops(rng, n):
    bases = [rng.integers(0, 100, 12) for _ in range(2)]
    ops = []
    for _ in range(n):
        r = rng.random()
        slot = int(rng.integers(0, 3))
        if r < 0.35:
            base = bases[int(rng.integers(0, 2))]
            cut = int(rng.choice([4, 8, 9, 12]))
            tail = rng.integers(0, 100, int(rng.integers(0, 5)))
            prompt = np.concatenate([base[:cut], tail]).astype(np.int32)
            ops.append(("admit", slot, (prompt, int(rng.integers(1, 5)))))
        elif r < 0.7:
            ops.append(("append", slot, None))
        elif r < 0.9:
            ops.append(("free", slot, None))
        else:
            ops.append(("evict", slot, int(rng.integers(1, 4))))
    return ops


def _differential(models, ops, kv_dtype):
    jcfg, _, cfg, _ = models
    kw = dict(n_slots=3, max_len=24, block_size=4, n_blocks=14,
              kv_dtype=kv_dtype)
    jc, tc = JCache(jcfg, **kw), PagedKVCache(cfg, device="cpu", **kw)
    # same random page contents on both sides, so COW copies can be
    # compared byte for byte
    rng = np.random.default_rng(1)
    names = ["k_pages", "v_pages"] + (
        ["k_scales", "v_scales"] if kv_dtype == "int8" else [])
    for name in names:
        ref_arr = np.asarray(getattr(jc, name))
        if ref_arr.dtype == np.int8:
            vals = rng.integers(-128, 128, ref_arr.shape).astype(np.int8)
        else:
            vals = rng.normal(size=ref_arr.shape).astype(ref_arr.dtype)
        setattr(jc, name, jnp.asarray(vals))
        getattr(tc, name).copy_(torch.from_numpy(vals))
    ji, ti = JIndex(4), PrefixIndex(4)
    jb, tb = [0] * 3, [0] * 3
    for op in ops:
        _apply(op, jc, ji, jb)
        _apply(op, tc, ti, tb)
        assert _cache_state(tc, ti) == _cache_state(jc, ji), op
        jc.check_invariants(ji.page_refs())
        tc.check_invariants(ti.page_refs())
    for name in names:
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    return tc


@pytest.mark.parametrize("seed,kv_dtype", [(0, "bf16"), (1, "int8"),
                                           (2, "bf16")])
def test_cache_and_index_differential(models, seed, kv_dtype):
    tc = _differential(models, _ops(np.random.default_rng(seed), 60),
                       kv_dtype)
    assert tc.pages_allocated > 0


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_cache_and_index_differential_property(models, seed):
    _differential(models, _ops(np.random.default_rng(seed), 30), "bf16")


# ---------------------------------------------------------------------------
# drains against the reference
# ---------------------------------------------------------------------------

N_REQUESTS, MAX_PROMPT, NEW_TOKENS, N_SLOTS, BLOCK = 8, 16, 6, 3, 4


def _serve_bench_trace(vocab):
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
           cache_len, **kw):
    cb = batcher_cls(cfg, params, n_slots=N_SLOTS, cache_len=cache_len,
                     paged=True, block_size=BLOCK, **kw)
    for uid, p in enumerate(prompts):
        cb.submit(request_cls(uid=uid, prompt=to_prompt(p),
                              max_new_tokens=NEW_TOKENS))
    res = cb.run_until_drained()
    pc = cb.pcache
    stats = dict(ticks=cb.ticks, prefill_tokens=cb.prefill_tokens,
                 decode_tokens=sum(len(v) for v in res.values()),
                 pages_allocated=pc.pages_allocated,
                 cow_events=pc.cow_events)
    if cb.prefix is not None:
        stats.update(hits=cb.prefix.hits,
                     cached=cb.prefix.cached_tokens_served)
    pc.check_invariants(None if cb.prefix is None
                        else cb.prefix.page_refs())
    return {u: list(v) for u, v in res.items()}, stats


def _both(models, prompts, cache_len, **kw):
    jcfg, jp, cfg, tp = models
    ref = _drain(JBatcher, JRequest, jcfg, jp, prompts, jnp.asarray,
                 cache_len, **kw)
    port = _drain(ContinuousBatcher, Request, cfg, tp, prompts,
                  lambda p: p, cache_len, device="cpu", **kw)
    assert port[1] == ref[1]
    assert port[0] == ref[0]
    return port


@pytest.fixture(scope="module")
def trace(models):
    return _serve_bench_trace(models[2].vocab_size)


@pytest.fixture(scope="module")
def single_shot(models, trace):
    return _both(models, trace, MAX_PROMPT + NEW_TOKENS + 2)


def test_drain_matches_reference_and_pinned_baseline(single_shot, trace):
    tokens, stats = single_shot
    # benchmarks/baselines.json: serve.paged.{ticks,decode_tokens}
    assert stats["ticks"] == 15
    assert stats["decode_tokens"] == 48
    assert stats["prefill_tokens"] == sum(
        -(-len(p) // BLOCK) * BLOCK for p in trace)
    assert all(len(v) == NEW_TOKENS for v in tokens.values())


def test_drain_int8_kv_matches_reference(models, trace):
    tokens, stats = _both(models, trace, MAX_PROMPT + NEW_TOKENS + 2,
                          kv_dtype="int8")
    assert stats["ticks"] == 15 and stats["decode_tokens"] == 48


def test_drain_chunked_prefill_matches_reference_and_single_shot(
        models, trace, single_shot):
    tokens, stats = _both(models, trace, MAX_PROMPT + NEW_TOKENS + 2,
                          prefill_chunk=8)
    assert tokens == single_shot[0]


def test_drain_prefix_index_matches_reference(models, trace):
    """Every prompt opens with a shared 8-token system prompt, so later
    requests hit the index and prefill only their suffix (start > 0)."""
    shared = np.arange(3, 11, dtype=np.int32)
    prompts = [np.concatenate([shared, p]) for p in trace]
    tokens, stats = _both(models, prompts, 8 + MAX_PROMPT + NEW_TOKENS + 2,
                          prefix=True)
    assert stats["hits"] > 0 and stats["cached"] > 0


def test_engine_generate_paged_matches_reference(models):
    jcfg, jp, cfg, tp = models
    prompts = np.random.default_rng(3).integers(0, 128, (3, 10)).astype(
        np.int32)
    for kw in ({}, {"prefill_chunk": 4}, {"kv_dtype": "int8"}):
        sc = dict(max_cache_len=32, max_new_tokens=6, paged=True,
                  block_size=4, **kw)
        ref = JEngine(jcfg, jp, JServeConfig(**sc)).generate(
            jnp.asarray(prompts))
        port = ServeEngine(cfg, tp, ServeConfig(device="cpu", **sc)).generate(
            prompts)
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# scheduler contracts held inside the port
# ---------------------------------------------------------------------------

def test_eos_stops_slot_and_frees_pages_the_same_tick(models, trace,
                                                      single_shot):
    """The output stops at EOS (kept) and the slot's pages are released
    the tick it is emitted, while other slots still decode."""
    _, _, cfg, tp = models
    base = single_shot[0]
    # an EOS that request 0 first emits in decode (from its 4th token
    # on), not at prefill, so it finishes mid-drain with its slot busy
    stop0 = next(j for j in range(3, NEW_TOKENS)
                 if base[0].index(base[0][j]) == j)
    eos = base[0][stop0]
    cb = ContinuousBatcher(cfg, tp, n_slots=N_SLOTS,
                           cache_len=MAX_PROMPT + NEW_TOKENS + 2, paged=True,
                           block_size=BLOCK, eos_token=eos, device="cpu")
    for uid, p in enumerate(trace):
        cb.submit(Request(uid=uid, prompt=p, max_new_tokens=NEW_TOKENS))
    freed_tick = None
    while cb.queue or any(s is not None for s in cb.slots):
        cb.step()
        if 0 in cb.finished and freed_tick is None:
            freed_tick = cb.ticks
            assert cb.pcache.owned_blocks(0) == ()
            assert cb.pcache.lengths[0] == 0
            cb.pcache.check_invariants()
    assert cb.finished[0] == base[0][: stop0 + 1]
    assert cb.finished[0][-1] == eos
    assert freed_tick is not None and freed_tick <= stop0 + 1
    assert len(cb.finished[0]) < NEW_TOKENS
    for u, toks in base.items():
        if eos not in toks:
            assert cb.finished[u] == toks
    cb.pcache.check_invariants()
    assert cb.pcache.n_free == cb.pcache.n_blocks - 1


def _slot_states(cb):
    pc = cb.pcache
    return dict(
        finished={u: list(v) for u, v in cb.finished.items()},
        ticks=cb.ticks,
        slots=[None if s is None else s.uid for s in cb.slots],
        queued=[r.uid for r in cb.queue],
        free=[list(p.free_blocks) for p in pc.pools],
        tables=[p.block_table.tolist() for p in pc.pools],
        lengths=pc.lengths.tolist())


def test_eos_at_prefill_matches_reference(models):
    """`tests/test_paged_cache.py::test_batcher_eos_stops_slot_and_frees_
    pages`'s case (prompts of 5, 8 and 13 tokens, 3 slots, 8 new tokens),
    with the EOS set to the token request 0 emits at prefill — which is
    what that test's `base[0][3]` picks under JAX 0.9.0. Request 0 ends
    at prefill; its pages free at once and the same tick's admission
    retries slot 0. The port's drain equals the reference's after every
    step: finished outputs, ticks, slot owners, queue, each group's free
    list and block tables, lengths."""
    jcfg, jp, cfg, tp = models
    key = jax.random.PRNGKey(7)
    prompts = [np.asarray(jax.random.randint(
        jax.random.fold_in(key, u), (t,), 0, cfg.vocab_size)).astype(
        np.int32) for u, t in enumerate([5, 8, 13])]
    kw = dict(n_slots=3, cache_len=32, paged=True, block_size=4)
    jbase = JBatcher(jcfg, jp, **kw)
    for u, p in enumerate(prompts):
        jbase.submit(JRequest(uid=u, prompt=jnp.asarray(p),
                              max_new_tokens=8))
    base = jbase.run_until_drained()
    eos = base[0][0]
    jb = JBatcher(jcfg, jp, eos_token=eos, **kw)
    tb = ContinuousBatcher(cfg, tp, eos_token=eos, device="cpu", **kw)
    for u, p in enumerate(prompts):
        jb.submit(JRequest(uid=u, prompt=jnp.asarray(p), max_new_tokens=8))
        tb.submit(Request(uid=u, prompt=p, max_new_tokens=8))
    states = []
    while jb.queue or any(s is not None for s in jb.slots):
        jb.step()
        tb.step()
        states.append(_slot_states(tb))
        assert states[-1] == _slot_states(jb), len(states)
        tb.pcache.check_invariants()
    assert not tb.queue and all(s is None for s in tb.slots)
    first = states[0]
    # request 0 finished at prefill, with its one token, in tick 1
    assert first["finished"][0] == [eos] and first["ticks"] == 1
    # its slot was refilled the same tick, by the next queued request
    assert first["slots"][0] == 1 and first["queued"] == []
    for u in (1, 2):
        stop = base[u].index(eos) + 1 if eos in base[u] else 8
        assert tb.finished[u] == base[u][:stop]
    pc = tb.pcache
    assert [len(p.free_blocks) for p in pc.pools] == [
        p.n_blocks - 1 for p in pc.pools]


def test_deadlock_raises_with_pool_diagnostic(models):
    _, _, cfg, tp = models
    cb = ContinuousBatcher(cfg, tp, n_slots=2, cache_len=24, paged=True,
                           block_size=4, n_blocks=3, device="cpu")
    cb.submit(Request(uid=0, prompt=np.arange(16, dtype=np.int32),
                      max_new_tokens=6))
    with pytest.raises(RuntimeError, match="deadlock.*per-group draw deficit"):
        cb.run_until_drained()


def test_step_signatures_stay_bounded(models, trace):
    """The trace_count analog: a drain logs one entry per distinct
    (step, plans, shape signature) — on CPU the plain version takes no
    plans, so prefill logs one entry per padded suffix width and decode
    one in all."""
    _, _, cfg, tp = models
    before = trace_count("decode"), trace_count("prefill")
    cb = ContinuousBatcher(cfg, tp, n_slots=N_SLOTS,
                           cache_len=MAX_PROMPT + NEW_TOKENS + 2, paged=True,
                           block_size=BLOCK, device="cpu")
    for uid, p in enumerate(trace):
        cb.submit(Request(uid=uid, prompt=p, max_new_tokens=NEW_TOKENS))
    cb.run_until_drained()
    widths = {-(-len(p) // BLOCK) * BLOCK for p in trace}
    assert cb._decode_paged.cache_size() == 1
    assert cb._prefill_paged.cache_size() == len(widths)
    assert trace_count("decode") - before[0] == 1
    assert trace_count("prefill") - before[1] == len(widths)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cpu_decode_stays_eager(models, trace, kv_dtype):
    """On the CPU the paged decode step runs eagerly, as before the
    card's CUDA graphs: they never apply, each decode's logits and the
    drain's tokens equal those of the step with no graphs at all, the
    signatures logged (`trace_count`) are the same, and the telemetry's
    graph counters read 0 and stay out of its registry, so its summary
    is still the reference's."""
    _, _, cfg, tp = models
    runs = {}
    for graphs in (True, False):
        tel = ServeTelemetry()
        cb = ContinuousBatcher(cfg, tp, n_slots=N_SLOTS,
                               cache_len=MAX_PROMPT + NEW_TOKENS + 2,
                               paged=True, block_size=BLOCK, device="cpu",
                               kv_dtype=kv_dtype, telemetry=tel)
        step = cb._decode_paged
        if not graphs:
            step.graphs = None
        logits = []

        def call(*args, step=step, logits=logits, **kw):
            out = step(*args, **kw)
            logits.append(out[0].clone())
            return out
        cb._decode_paged = call
        before = trace_count("decode")
        for uid, p in enumerate(trace):
            cb.submit(Request(uid=uid, prompt=p, max_new_tokens=NEW_TOKENS))
        res = cb.run_until_drained()
        runs[graphs] = (res, logits, trace_count("decode") - before, step,
                        tel)
    (res, logits, signatures, step, tel) = runs[True]
    assert res == runs[False][0]
    assert len(logits) == len(runs[False][1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(logits, runs[False][1]))
    assert signatures == runs[False][2] == 1
    assert not tel.registry.find("serve_decode_graph_captures")
    assert not tel.registry.find("serve_decode_graph_replays")
    assert not [k for k in tel.summary()["metrics"] if "graph" in k]


def test_k1_cut_sees_each_layer_and_changes_nothing(models):
    """`models.attention.K1_CUT`, where the piecewise decode graphs cut
    the step: set, each layer's K1 call of a paged decode step is handed
    to it once, and a cut that runs the call as `_select_bucket_plan`
    does leaves logits and pools bit for bit."""
    from repro_torch.models import attention, decode_step_paged

    _, _, cfg, tp = models
    pc = PagedKVCache(cfg, n_slots=2, max_len=16, block_size=4,
                      device="cpu")
    for slot, n in enumerate((9, 3)):
        pc.alloc_slot(slot, n)
        pc.lengths[slot] = n
    tok = torch.tensor([[5], [7]], dtype=torch.int32)
    bt, st = pc.device_block_tables(), pc.device_block_starts()
    pos = pc.device_positions()
    seen = []

    def cut(call, plans, perms, plan_class):
        seen.append(plan_class)
        return attention._select_bucket_plan(call, plans, perms, plan_class)

    def run(k1_cut):
        kp, vp = pc.k_pages.clone(), pc.v_pages.clone()
        token = attention.K1_CUT.set(k1_cut)
        try:
            logits = decode_step_paged(tp, tok, kp, vp, bt, pos, cfg,
                                       impl="ref", block_start=st)[0]
        finally:
            attention.K1_CUT.reset(token)
        return logits, kp, vp

    eager, through_cut = run(None), run(cut)
    assert len(seen) == cfg.n_layers
    assert all(torch.equal(a, b) for a, b in zip(eager, through_cut))


def test_each_run_runs_at_once_outside_a_capture(models):
    """`serve.graphs.each_run` outside a decode graph's capture (every
    CPU step) runs its host work at once, in the order handed over: a
    reading made through it in each eager decode sees every decode."""
    from repro_torch.serve.graphs import each_run

    seen = []
    each_run(lambda: seen.append(1))
    each_run(lambda: seen.append(2))
    assert seen == [1, 2]

    _, _, cfg, tp = models
    cb = ContinuousBatcher(cfg, tp, n_slots=N_SLOTS,
                           cache_len=MAX_PROMPT + NEW_TOKENS + 2,
                           paged=True, block_size=BLOCK, device="cpu")
    step, shapes = cb._decode_paged, []

    def call(*args, **kw):
        out = step(*args, **kw)
        each_run(lambda: shapes.append(tuple(out[0].shape)))
        return out
    cb._decode_paged = call
    cb.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32),
                      max_new_tokens=NEW_TOKENS))
    cb.run_until_drained()
    assert shapes == [(N_SLOTS, 1, cfg.vocab_size)] * (NEW_TOKENS - 1)


def test_unported_modes_raise(models):
    """The page-pool options without `paged=True` raise the reference's
    `ValueError`s, in both packages; the dense cache itself runs, and
    telemetry is taken in both modes."""
    jcfg, jp, cfg, tp = models
    for kw in (dict(prefix=True), dict(kv_dtype="int8"),
               dict(prefill_chunk=8), dict(group_blocks="auto")):
        with pytest.raises(ValueError) as ref:
            JBatcher(jcfg, jp, n_slots=1, cache_len=8, **kw)
        with pytest.raises(ValueError) as port:
            ContinuousBatcher(cfg, tp, n_slots=1, cache_len=8,
                              device="cpu", **kw)
        assert str(port.value).split(" (")[0] == \
            str(ref.value).split(" (")[0], kw
    with pytest.raises(ValueError, match="kv_dtype='int8' requires paged"):
        ServeEngine(cfg, tp, ServeConfig(kv_dtype="int8", device="cpu"))
    for paged in (False, True):
        tel = ServeTelemetry()
        cb = ContinuousBatcher(cfg, tp, n_slots=1, cache_len=8, paged=paged,
                               telemetry=tel, device="cpu")
        assert cb.telemetry is tel and cb.paged is paged
    out = ServeEngine(cfg, tp, ServeConfig(device="cpu", max_new_tokens=2)
                      ).generate(np.zeros((1, 4), np.int32))
    assert out.shape == (1, 2)


def test_entry_points_default_to_the_card(models):
    """Without a card the default device raises instead of moving to the
    CPU; the CPU runs only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, cfg, tp = models
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(cfg, tp, n_slots=1, cache_len=8, paged=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(cfg, n_slots=1, max_len=8)
