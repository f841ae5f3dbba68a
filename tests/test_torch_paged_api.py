"""The paged cache's public API in the PyTorch port, held against the JAX
reference op by op.

`PagedKVCache.is_shared`, `can_fit`, `alloc_slot`, `ensure_capacity`,
`attach_shared`, `append_position` and `write_suffix` (with its
`_gather_window`), and `PrefixIndex.lookup` and `drop_all`. Every
sequence runs on a reference cache and a port cache side by side
(`Pair`): each op is applied to both, both return the same value or
raise the same error, and after every op the block tables, first live
blocks, free lists, refcounts, reservation ledgers, owned page lists,
lengths, counters and pool contents are equal, and `check_invariants`
passes on both. Float pools are compared exactly. Int8 scales are
compared to 1e-6 relative (both divide the same f32 absmax by 127);
codes exactly where the page's scale is bit-identical, within one code
where it is not.

The sequences are those of the reference's `tests/test_paged_cache.py`,
`tests/test_prefix_cache.py` (the hypothesis random-op test too, whose
content stamps show that shared pages are never written in place) and
`tests/test_kv_quant.py`, on the same configs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.serve import PagedKVCache as JCache
from repro.serve import PrefixIndex as JIndex
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.serve import PagedKVCache, PrefixIndex
from repro_torch.serve.paged_cache import SCRATCH_PAGE

#: int8 scales: both sides compute absmax / 127 in f32
SCALE_RTOL = 1e-6


def _tiny(cls):
    """The reference tests' 1-layer config for cheap cache-level ops."""
    return cls(name="tiny", family="dense", n_layers=1, d_model=8,
               n_heads=2, n_kv_heads=1, d_ff=16, vocab_size=32,
               dtype="float32")


def _smoke(arch="qwen2-1.5b"):
    return (dataclasses.replace(j_get_config(arch, smoke=True),
                                dtype="float32"),
            dataclasses.replace(get_config(arch, smoke=True),
                                dtype="float32"))


def _host_state(c):
    return ([(p.block_table.tolist(), p.first_block.tolist(),
              list(p.free_blocks), dict(p._ref), dict(p._reserved),
              {s: d for s, d in p._drawn.items() if d or s in p._reserved},
              [list(o) for o in p._owned], p.pages_allocated, p.cow_events,
              p.pages_retired) for p in c.pools],
            c.lengths.tolist())


def _pools_equal(j, t):
    if t.quantized:
        for codes, scales in (("k_pages", "k_scales"), ("v_pages", "v_scales")):
            js = np.asarray(getattr(j, scales))
            ts = getattr(t, scales).numpy()
            np.testing.assert_allclose(ts, js, rtol=SCALE_RTOL, atol=0)
            jc = np.asarray(getattr(j, codes)).astype(np.int32)
            tc = getattr(t, codes).numpy().astype(np.int32)
            same = (js == ts)[:, :, None, :, None]      # [L, P, 1, KV, 1]
            diff = np.abs(jc - tc)
            assert np.all(np.where(same, diff, 0) == 0), codes
            assert diff.max() <= 1, codes
    else:
        for name in ("k_pages", "v_pages"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)))


def _to_j(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _to_t(a):
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


class Pair:
    """A reference cache and a port cache driven in lockstep."""

    def __init__(self, jcfg, tcfg, **kw):
        self.j = JCache(jcfg, **kw)
        self.t = PagedKVCache(tcfg, device="cpu", **kw)
        self.check()

    def __getattr__(self, name):
        def op(*args, ext=None, **kw):
            errs, outs = [], []
            for obj, conv in ((self.j, _to_j), (self.t, _to_t)):
                try:
                    outs.append(getattr(obj, name)(
                        *[conv(a) for a in args],
                        **{k: conv(v) for k, v in kw.items()}))
                    errs.append(None)
                except (MemoryError, ValueError, AssertionError) as e:
                    outs.append(None)
                    errs.append((type(e), str(e)))
            assert errs[0] == errs[1], (name, errs)
            assert outs[0] == outs[1], (name, outs)
            self.check(ext)
            if errs[1] is not None:
                raise errs[1][0](errs[1][1])
            return outs[1]
        return op

    def set_length(self, slot, n):
        self.j.lengths[slot] = n
        self.t.lengths[slot] = n

    def check(self, ext=None):
        """State equal on both sides; then `check_invariants(ext)` on
        both, unless `ext` is False (a release by a non-holder, which
        the reference's own test does not check either)."""
        assert _host_state(self.t) == _host_state(self.j)
        _pools_equal(self.j, self.t)
        if ext is False:
            return
        self.j.check_invariants(ext)
        self.t.check_invariants(ext)


class IndexPair:
    """A reference index over `pair.j` and a port index over `pair.t`."""

    def __init__(self, pair, **kw):
        self.pair = pair
        self.j, self.t = JIndex(**kw), PrefixIndex(**kw)

    def __getattr__(self, name):
        def op(*args, **kw):
            if name == "publish":                # (tokens, cache, slot)
                rj = self.j.publish(args[0], self.pair.j, *args[1:], **kw)
                rt = self.t.publish(args[0], self.pair.t, *args[1:], **kw)
            elif name in ("evict", "drop_all", "page_cap"):
                rj = getattr(self.j, name)(self.pair.j, *args, **kw)
                rt = getattr(self.t, name)(self.pair.t, *args, **kw)
            else:
                rj = getattr(self.j, name)(*args, **kw)
                rt = getattr(self.t, name)(*args, **kw)
            assert rt == rj, (name, rt, rj)
            assert self.t.page_refs() == self.j.page_refs()
            assert len(self.t) == len(self.j)
            assert self.t.retained_pages == self.j.retained_pages
            assert self.t.evicted_pages == self.j.evicted_pages
            self.pair.check(self.t.page_refs())
            return rt
        return op


def _stamp_kv(stamps, hd=4):
    """[L=1, T, KV=1, hd] rows holding one recognizable value per token."""
    a = np.array(stamps, np.float32)[None, :, None, None]
    return np.ascontiguousarray(a * np.ones((1, len(stamps), 1, hd),
                                            np.float32))


def _slot_stamps(c, slot, n, pool):
    bs = c.block_size
    owned = c.owned_blocks(slot)
    return [float(pool[0, owned[p // bs], p % bs, 0, 0]) for p in range(n)]


# ---------------------------------------------------------------------------
# tests/test_paged_cache.py's bookkeeping sequences
# ---------------------------------------------------------------------------

def test_alloc_free_recycle_invariants():
    pc = Pair(*_smoke(), n_slots=3, max_len=32, block_size=4)
    total_free = pc.t.n_free
    pc.alloc_slot(0, 10)
    pc.alloc_slot(1, 4)
    assert pc.t.n_free == total_free - 4
    blocks0 = pc.t.owned_blocks(0)
    pc.free_slot(0)
    assert np.all(pc.t.block_table[0] == SCRATCH_PAGE)
    pc.alloc_slot(2, 12)
    assert set(blocks0) & set(pc.t.owned_blocks(2))
    for b in pc.t.owned_blocks(2):
        assert pc.is_shared(b) is False
    with pytest.raises(AssertionError, match="already allocated"):
        pc.alloc_slot(2, 4)


def test_append_position_across_boundaries():
    pc = Pair(*_smoke(), n_slots=2, max_len=16, block_size=4)
    pc.alloc_slot(0, 3)
    pc.set_length(0, 3)
    pc.check()
    pc.append_position(0)
    assert len(pc.t.owned_blocks(0)) == 1
    pc.append_position(0)
    assert len(pc.t.owned_blocks(0)) == 2
    assert pc.t.lengths[0] == 5


def test_pool_exhaustion_and_overflow_raise_the_same_errors():
    pc = Pair(*_smoke(), n_slots=2, max_len=8, block_size=4, n_blocks=4)
    pc.alloc_slot(0, 8)
    pc.alloc_slot(1, 4)
    assert pc.can_fit(4) is False
    with pytest.raises(MemoryError):
        pc.ensure_capacity(1, 8)
    with pytest.raises(ValueError):
        pc.ensure_capacity(0, 9)


def test_reservations_gate_admission_and_can_fit():
    pc = Pair(*_smoke(), n_slots=3, max_len=16, block_size=4, n_blocks=9)
    assert pc.can_fit(16) is True
    assert pc.reserve_slot(0, 16)
    assert pc.reserve_slot(1, 13)
    assert pc.can_fit(4) is False
    assert not pc.reserve_slot(2, 4)
    pc.alloc_slot(0, 4)
    pc.ensure_capacity(0, 16)
    pc.free_slot(0)
    assert pc.can_fit(16) is True
    assert pc.reserve_slot(2, 16)


def test_windowed_groups_alloc_append_and_can_fit():
    """gemma3 smoke: two layer groups, one windowed (window 8), whose
    pages retire as `append_position` walks past the window."""
    pc = Pair(*_smoke("gemma3-27b"), n_slots=2, max_len=32, block_size=4,
              n_blocks=12, prefill_chunk=4)
    assert len(pc.t.pools) == 2
    pc.alloc_slot(0, 4)
    pc.set_length(0, 4)
    pc.check()
    for _ in range(20):
        pc.append_position(0)
        pc.can_fit(8)
    assert pc.t.pages_retired > 0
    pc.free_slot(0)


# ---------------------------------------------------------------------------
# tests/test_prefix_cache.py's index and copy-on-write sequences
# ---------------------------------------------------------------------------

def _tiny_pair(**kw):
    return Pair(_tiny(JModelConfig), _tiny(ModelConfig), **kw)


def test_index_lookup_longest_full_page_prefix():
    pc = _tiny_pair(n_slots=2, max_len=16, block_size=4)
    ix = IndexPair(pc, block_size=4)
    prompt = np.arange(10)
    pc.alloc_slot(0, 10)
    ix.publish(prompt, 0)
    assert ix.lookup(prompt) == list(pc.t.owned_blocks(0)[:2])
    assert ix.lookup(np.arange(6)) == [pc.t.owned_blocks(0)[0]]
    assert ix.lookup(np.arange(3)) == []
    other = np.concatenate([np.arange(100, 104), np.arange(4, 8)])
    assert ix.lookup(other) == []
    keys = ix.block_keys(prompt)
    assert ix.lookup(prompt, keys=keys[:1]) == [pc.t.owned_blocks(0)[0]]


def test_index_first_writer_wins_then_drop_all():
    pc = _tiny_pair(n_slots=2, max_len=16, block_size=4)
    ix = IndexPair(pc, block_size=4)
    pc.alloc_slot(0, 8)
    pc.alloc_slot(1, 8)
    assert ix.publish(np.arange(8), 0) == 2
    assert ix.publish(np.arange(8), 1) == 0
    assert ix.lookup(np.arange(8)) == list(pc.t.owned_blocks(0))
    assert ix.drop_all() == 2
    assert ix.lookup(np.arange(8)) == []
    pc.free_slot(0)
    pc.free_slot(1)
    assert pc.t.n_free == pc.t.n_blocks - 1


def test_retained_fraction_cap_with_drop_all():
    pc = _tiny_pair(n_slots=4, max_len=16, block_size=4, n_blocks=17)
    ix = IndexPair(pc, block_size=4, max_retained_fraction=0.25)
    for i in range(3):
        pc.alloc_slot(0, 8)
        ix.publish(np.arange(i * 100, i * 100 + 8), 0)
        pc.free_slot(0, ext=ix.t.page_refs())
    assert ix.t.retained_pages == 4 and ix.t.evicted_pages == 2
    assert ix.drop_all() == 4
    pc.alloc_slot(0, 8)
    ix.publish(np.arange(8), 0)
    pc.alloc_slot(1, 8)
    ix.publish(np.arange(50, 58), 1)
    pc.alloc_slot(2, 8)
    assert ix.publish(np.arange(900, 908), 2) == 0
    for slot in range(3):
        pc.free_slot(slot, ext=ix.t.page_refs())
    assert ix.drop_all() == 4
    assert pc.t.n_free == pc.t.n_blocks - 1


def test_attach_shared_refcounts_and_last_free_recycles():
    pc = _tiny_pair(n_slots=3, max_len=16, block_size=4)
    pc.alloc_slot(0, 8)
    pages = list(pc.t.owned_blocks(0))
    pc.attach_shared(1, pages, ext={})
    pc.attach_shared(2, pages[:1], ext={})
    assert pc.t.refcount(pages[0]) == 3 and pc.t.refcount(pages[1]) == 2
    assert pc.is_shared(pages[0]) and pc.is_shared(pages[1])
    with pytest.raises(ValueError, match="shared pages exceed max"):
        pc.attach_shared(0, list(range(1, 6)))
    free0 = pc.t.n_free
    pc.free_slot(0, ext={})
    pc.free_slot(1, ext={})
    assert pc.t.n_free == free0 + 1
    pc.free_slot(2, ext={})
    assert pc.t.n_free == free0 + 2


def test_cow_never_writes_shared_page_in_place():
    pc = _tiny_pair(n_slots=2, max_len=16, block_size=4)
    s = _stamp_kv([1, 2, 3, 4, 5])
    pc.write_suffix(0, s, s, 0, 5)
    pages = list(pc.t.owned_blocks(0))
    pc.attach_shared(1, pages[:1])
    s = _stamp_kv([77, 88])
    pc.write_suffix(1, s, s, 3, 2)                # mid-page: COW first
    assert pc.t.cow_events == 1
    pool = pc.t.k_pages.numpy()
    assert _slot_stamps(pc.t, 0, 5, pool) == [1, 2, 3, 4, 5]
    assert _slot_stamps(pc.t, 1, 5, pool) == [1, 2, 3, 77, 88]


def test_exclusive_page_append_skips_cow():
    pc = _tiny_pair(n_slots=1, max_len=16, block_size=4)
    pc.write_suffix(0, _stamp_kv([1, 2]), _stamp_kv([1, 2]), 0, 2)
    pc.write_suffix(0, _stamp_kv([3]), _stamp_kv([3]), 2, 1)
    assert pc.t.cow_events == 0
    assert _slot_stamps(pc.t, 0, 3, pc.t.k_pages.numpy()) == [1, 2, 3]


def test_reservations_account_shared_and_cow_draws():
    pc = _tiny_pair(n_slots=3, max_len=32, block_size=4, n_blocks=9)
    pc.alloc_slot(0, 16)
    shared = list(pc.t.owned_blocks(0))
    assert not pc.reserve_slot(1, 32, n_shared=4, n_cow=1)
    assert pc.reserve_slot(1, 28, n_shared=4, n_cow=1)
    pc.attach_shared(1, shared, ext={})
    pc.begin_append(1, 15, 1, ext={})
    assert pc.t.cow_events == 1
    pc.ensure_capacity(1, 28, ext={})


@given(st.data())
@settings(deadline=None, max_examples=40)
def test_pool_random_ops_match_reference(data):
    """The reference's random admit/share/append/free test on both
    packages: both return the same values, hold the same host state
    and pools after every op, and every slot reads back its own stamps
    through its block table on both sides."""
    bs, max_len = 4, 24
    pc = _tiny_pair(n_slots=3, max_len=max_len, block_size=bs, n_blocks=20)
    expected = {}
    next_stamp = [1.0]

    def fresh(n):
        out = [next_stamp[0] + i for i in range(n)]
        next_stamp[0] += n
        return out

    for _ in range(data.draw(st.integers(4, 12), label="n_ops")):
        live = sorted(expected)
        empty = [s for s in range(3) if s not in expected]
        ops = []
        if empty and pc.t.n_free >= max_len // bs:
            ops.append("start")
        if live:
            ops.append("free")
            if pc.t.n_free >= 2:
                ops.append("append")
        if not ops:
            break
        op = data.draw(st.sampled_from(ops), label="op")
        if op == "start":
            slot = data.draw(st.sampled_from(empty), label="slot")
            donors = [s for s in live if len(expected[s]) >= bs]
            start = 0
            if donors and data.draw(st.booleans(), label="share"):
                donor = data.draw(st.sampled_from(donors), label="donor")
                k_max = min(len(expected[donor]) // bs, (max_len - 1) // bs)
                k = data.draw(st.integers(1, k_max), label="k")
                pc.attach_shared(slot, pc.t.owned_blocks(donor)[:k], ext={})
                start = k * bs - int(data.draw(st.booleans(), label="mid"))
                expected[slot] = list(expected[donor][:start])
            else:
                expected[slot] = []
            n = data.draw(st.integers(1, max_len - start), label="n")
            stamps = fresh(n)
            pc.write_suffix(slot, _stamp_kv(stamps), _stamp_kv(stamps),
                            start, n, ext={})
            expected[slot] += stamps
        elif op == "append":
            slot = data.draw(st.sampled_from(live), label="slot")
            n = len(expected[slot])
            if n >= max_len:
                continue
            stamps = fresh(1)
            pc.write_suffix(slot, _stamp_kv(stamps), _stamp_kv(stamps), n, 1,
                            ext={})
            expected[slot] += stamps
        else:
            slot = data.draw(st.sampled_from(live), label="slot")
            pc.free_slot(slot, ext={})
            del expected[slot]
        for c, pool in ((pc.t, pc.t.k_pages.numpy()),
                        (pc.j, np.asarray(pc.j.k_pages))):
            for slot, exp in expected.items():
                assert _slot_stamps(c, slot, len(exp), pool) == exp
    for slot in sorted(expected):
        pc.free_slot(slot, ext={})
    assert pc.t.n_free == pc.t.n_blocks - 1


@given(st.data())
@settings(deadline=None, max_examples=20)
def test_refcount_zero_exactly_at_last_release(data):
    pc = _tiny_pair(n_slots=3, max_len=8, block_size=4)
    pc.alloc_slot(0, 4)
    page = pc.t.owned_blocks(0)[0]
    holders = data.draw(st.integers(0, 2), label="extra_slots")
    retains = data.draw(st.integers(0, 3), label="index_retains")
    for s in range(1, 1 + holders):
        pc.attach_shared(s, [page])
    for _ in range(retains):
        pc.retain(page)
    total = 1 + holders + retains
    for i in range(total):
        assert pc.is_shared(page, ext=False) == (total - i > 1)
        pc.release(page, ext=False)
    assert page in pc.t.free_blocks and page in pc.j.free_blocks


# ---------------------------------------------------------------------------
# tests/test_kv_quant.py's int8 sequences, and the windowed writer
# ---------------------------------------------------------------------------

def test_int8_ragged_final_page():
    pc = Pair(*_smoke(), n_slots=2, max_len=16, block_size=4,
              kv_dtype="int8")
    L, kvh, hd = (pc.t.k_pages.shape[0], pc.t.k_pages.shape[3],
                  pc.t.k_pages.shape[4])
    rng = np.random.default_rng(3)
    k = (rng.normal(size=(L, 7, kvh, hd)) * 0.1).astype(np.float32)
    v = (rng.normal(size=(L, 7, kvh, hd)) * 0.1).astype(np.float32)
    pc.alloc_slot(0, 7)
    pc.write_suffix(0, k, v, 0, 7)
    assert pc.t.lengths[0] == 7


def test_int8_cow_then_append_content_stamp():
    pc = Pair(*_smoke(), n_slots=2, max_len=16, block_size=4,
              kv_dtype="int8")
    L, kvh, hd = (pc.t.k_pages.shape[0], pc.t.k_pages.shape[3],
                  pc.t.k_pages.shape[4])
    rng = np.random.default_rng(4)
    k = rng.normal(size=(L, 4, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(L, 4, kvh, hd)).astype(np.float32)
    pc.alloc_slot(0, 3)
    pc.write_suffix(0, k, v, 0, 3)
    page = pc.t.pools[0]._owned[0][0]
    pc.retain(page, ext={page: 1})
    assert pc.is_shared(page, ext={page: 1})
    codes = pc.t.k_pages[:, page].clone()
    scales = pc.t.k_scales[:, page].clone()
    tok_k = rng.normal(size=(L, 1, kvh, hd)).astype(np.float32)
    tok_v = rng.normal(size=(L, 1, kvh, hd)).astype(np.float32)
    pc.write_suffix(0, tok_k, tok_v, 3, 1, ext={page: 1})
    assert pc.t.cow_events >= 1
    assert pc.t.pools[0]._owned[0][0] != page
    assert torch.equal(pc.t.k_pages[:, page], codes)
    assert torch.equal(pc.t.k_scales[:, page], scales)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_write_suffix_windowed_groups(kv_dtype):
    """gemma3 smoke (a global and a window-8 group): suffix writes in
    chunks retire the windowed group's dead pages; both groups' pools
    equal the reference's after every chunk."""
    pc = Pair(*_smoke("gemma3-27b"), n_slots=2, max_len=40, block_size=4,
              kv_dtype=kv_dtype, prefill_chunk=8)
    L, kvh, hd = (pc.t.k_pages.shape[0], pc.t.k_pages.shape[3],
                  pc.t.k_pages.shape[4])
    rng = np.random.default_rng(5)
    for start, n in ((0, 8), (8, 8), (16, 5), (21, 3), (24, 8)):
        k = rng.normal(size=(L, n, kvh, hd)).astype(np.float32)
        v = rng.normal(size=(L, n, kvh, hd)).astype(np.float32)
        pc.write_suffix(1, k, v, start, n)
    assert pc.t.pages_retired > 0
    pc.free_slot(1)
