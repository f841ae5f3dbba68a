"""Layer-major block-paged KV cache for continuous batching:
counterpart of `repro.serve.paged_cache`.

KV lives in fixed-size pages; a per-slot block table maps logical
position `p` to page `block_table[slot, p // block_size]`, and each slot
tracks its own length. Layers are partitioned by attention pattern
(`models.layer_attn_groups`), and every group owns an independent
page-id space (`LayerPagePool`): its own free list, refcounts, per-slot
block table and first-live-block vector. Pages are refcounted — a page
may back the same prefix of several slots and/or be retained by the
prefix index — and any write into a shared page first goes through
copy-on-write. Page 0 is the scratch page of every group: idle slots and
retired columns point at it, so unconditional KV writes of idle rows
land there.

The host bookkeeping is the reference's, line for line, in numpy. The
physical pools are torch tensors on the cache's device, stacked
`[L, n_blocks, bs, KV, hd]` (plus `[L, n_blocks, KV]` f32 scales for
int8 pools), and are updated IN PLACE: copy-on-write copies a group's
layer rows inside the stacked tensors, and the paged model entry points
write appended KV into them.
"""

from __future__ import annotations

import collections
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import init_paged_pool, layer_attn_groups
from ..models.common import resolve_device

#: the reserved scratch page id (never allocated)
SCRATCH_PAGE = 0


class LayerPagePool:
    """Host bookkeeping for ONE layer group's page-id space.

    Owns the free list, refcounts, per-slot block table and per-slot
    first-live-block counter; the physical KV rows live in the parent's
    stacked pools at `self.layers`. `window` is the group's attention
    window (None = global); `retire_window` is the window the RETIREMENT
    machinery uses — None disables retirement (the
    `window_retirement=False` lockstep-residency baseline) without
    changing the group partition or the attention math."""

    def __init__(self, gid: int, layers: Sequence[int],
                 window: Optional[int], n_slots: int, mb: int,
                 n_blocks: int, block_size: int, retire: bool,
                 live_bound: Optional[int] = None):
        self.gid = gid
        self.layers = tuple(layers)
        self.window = window
        self.retire_window = window if retire else None
        self.block_size = block_size
        self.max_blocks_per_slot = mb
        self.n_blocks = n_blocks
        #: retirement-aware admission (DESIGN.md §17): max net pool draws
        #: a slot can hold live at once — `ceil(window/bs) + slack` —
        #: sound only when every append spans at most the promised
        #: prefill chunk, so the parent only sets it when chunking is on
        #: and this group retires. None = reserve the worst case.
        self.live_bound = live_bound
        self.block_table = np.full((n_slots, mb), SCRATCH_PAGE, np.int32)
        #: leading blocks of each slot that are dead (retired or skipped
        #: at attach): their columns are scratch, the kernels start the
        #: walk past them
        self.first_block = np.zeros((n_slots,), np.int32)
        self.free_blocks: Deque[int] = collections.deque(
            range(1, n_blocks)
        )
        #: logical-block-aligned page list per slot; None = dead block
        self._owned: List[List[Optional[int]]] = [
            [] for _ in range(n_slots)
        ]
        #: refcount per allocated (non-free) page
        self._ref: Dict[int, int] = {}
        #: admission control: draws promised (reserve) vs made (_drawn)
        self._reserved: Dict[int, int] = {}
        self._drawn: Dict[int, int] = collections.defaultdict(int)
        #: lifetime counters
        self.pages_allocated = 0
        self.cow_events = 0
        self.pages_retired = 0
        #: high-water mark of simultaneously allocated pages, updated at
        #: draw time — per-tick sampling would miss a single-shot
        #: prefill's transient that retires within the same tick
        self.peak_allocated = 0

    # -- small accessors ---------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self.free_blocks)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def live_pages(self, slot: int) -> int:
        return sum(1 for p in self._owned[slot] if p is not None)

    def allocated_pages(self) -> int:
        return len(self._ref)

    def extra_refs(self) -> int:
        """References beyond the first, summed over allocated pages."""
        return sum(r - 1 for r in self._ref.values())

    def available_blocks(self) -> int:
        outstanding = sum(
            r - self._drawn[s] for s, r in self._reserved.items()
        )
        return self.n_free - outstanding

    # -- alloc / free ------------------------------------------------------

    def _pop_free(self, slot: int) -> int:
        if not self.free_blocks:
            raise MemoryError(
                f"paged KV pool exhausted (layer group {self.gid}, "
                f"window={self.window})"
            )
        b = self.free_blocks.popleft()
        self._ref[b] = 1
        self._drawn[slot] += 1
        self.pages_allocated += 1
        if len(self._ref) > self.peak_allocated:
            self.peak_allocated = len(self._ref)
        return b

    def retain(self, page: int) -> None:
        assert page in self._ref, (self.gid, page)
        self._ref[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; recycle at zero (LIFO — just-released
        pages are the likeliest to still be resident in a cache tier).
        Returns True when the page actually returned to the free list."""
        r = self._ref[page] - 1
        if r:
            self._ref[page] = r
            return False
        del self._ref[page]
        self.free_blocks.appendleft(page)
        return True

    def dead_blocks(self, q_min: int) -> int:
        """Blocks fully behind every remaining query's window: block j is
        dead iff its last position satisfies
        `(j+1)*bs - 1 <= q_min - window` — queries only move right, so
        dead stays dead."""
        if self.retire_window is None:
            return 0
        return max(0, (q_min - self.retire_window + 1) // self.block_size)

    def first_live_block(self, q_min: int) -> int:
        """Index of the first block a kernel walk must visit when the
        earliest remaining query sits at `q_min` (the dead leading block
        count)."""
        return self.dead_blocks(q_min)

    def retire(self, slot: int, q_min: int) -> int:
        """Window-aware page retirement (DESIGN.md §12): release every
        live block that fell fully behind the window of the earliest
        remaining query (`q_min`); the column falls back to scratch and
        the walk start advances past it. Returns pages released.

        Retirement-aware admission (§17): a recycled page draws down the
        slot's reservation ledger — the freed block and the restored
        entitlement cancel, so `available_blocks()` is unchanged and a
        live-bounded reservation keeps covering the slot's future draws
        as its live window slides forward. `_drawn` may go negative when
        a slot retires attached (never-drawn) pages; that only widens
        the slot's remaining entitlement by pages it physically returned,
        so the ledger stays conservative."""
        owned = self._owned[slot]
        target = min(self.dead_blocks(q_min), len(owned))
        released = 0
        for j in range(int(self.first_block[slot]), target):
            page = owned[j]
            if page is not None:
                if self.release(page) and slot in self._reserved:
                    self._drawn[slot] -= 1
                owned[j] = None
                self.block_table[slot, j] = SCRATCH_PAGE
                self.pages_retired += 1
                released += 1
        if target > self.first_block[slot]:
            self.first_block[slot] = target
        return released

    def grow(self, slot: int, q_min: int, n_tokens: int) -> None:
        """Extend the slot's block list to cover `n_tokens` positions.
        Blocks already dead for `q_min` (possible only below the write
        window) are marked dead at birth — no pool draw, no table entry."""
        need = -(-n_tokens // self.block_size)
        if need > self.max_blocks_per_slot:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens exceed max "
                f"{self.max_blocks_per_slot * self.block_size}"
            )
        owned = self._owned[slot]
        dead = self.dead_blocks(q_min)
        while len(owned) < need:
            j = len(owned)
            if j < dead:
                owned.append(None)
                self.first_block[slot] = max(
                    int(self.first_block[slot]), j + 1
                )
            else:
                b = self._pop_free(slot)
                self.block_table[slot, j] = b
                owned.append(b)

    def attach(self, slot: int, j0: int, pages: Sequence[int]) -> None:
        """Map shared pages as blocks [j0, j0 + len(pages)) of the slot's
        table (a prefix hit); blocks below j0 are dead (window-skipped)."""
        assert not self._owned[slot], (self.gid, slot)
        if not pages:
            return
        owned: List[Optional[int]] = [None] * j0
        for i, p in enumerate(pages):
            assert p != SCRATCH_PAGE and p in self._ref, (self.gid, p)
            self._ref[p] += 1
            self.block_table[slot, j0 + i] = p
            owned.append(p)
        self._owned[slot] = owned
        self.first_block[slot] = j0

    def free_slot(self, slot: int) -> None:
        for p in self._owned[slot]:
            if p is not None:
                self.release(p)
        self._owned[slot] = []
        self._reserved.pop(slot, None)
        self._drawn.pop(slot, None)
        self.block_table[slot, :] = SCRATCH_PAGE
        self.first_block[slot] = 0

    def make_writable(self, cache: "PagedKVCache", slot: int,
                      block_idx: int) -> None:
        """Copy-on-write for THIS group only: the page copy touches the
        group's layer rows of the parent's stacked pools (scales along
        with codes on int8 pools), in place."""
        old = self._owned[slot][block_idx]
        assert old is not None, (self.gid, slot, block_idx)
        if self._ref[old] <= 1:
            return
        new = self._pop_free(slot)
        lg = cache.group_layer_index(self.gid)
        stacks = [cache.k_pages, cache.v_pages]
        if cache.quantized:
            # a quantized page is (codes, scale) — COW moves both
            stacks += [cache.k_scales, cache.v_scales]
        for stack in stacks:
            stack[lg, new] = stack[lg, old]
        self._ref[old] -= 1
        self._owned[slot][block_idx] = new
        self.block_table[slot, block_idx] = new
        self.cow_events += 1

    def check_invariants(self, lengths: np.ndarray,
                         external: Optional[Dict[int, int]]) -> None:
        slot_holds: Dict[int, int] = collections.defaultdict(int)
        for slot, blocks in enumerate(self._owned):
            n = int(lengths[slot])
            assert len(blocks) * self.block_size >= n, \
                (self.gid, slot, blocks, n)
            first = int(self.first_block[slot])
            for j, b in enumerate(blocks):
                if b is None:
                    assert j < first, (self.gid, slot, j, first)
                    assert self.block_table[slot, j] == SCRATCH_PAGE
                    continue
                assert b != SCRATCH_PAGE, (self.gid, slot, j)
                assert int(self.block_table[slot, j]) == b, \
                    (self.gid, slot, j)
                slot_holds[b] += 1
        allocated = set(self._ref)
        free = set(self.free_blocks)
        assert len(free) == len(self.free_blocks), \
            f"group {self.gid}: duplicate free pages"
        assert not (allocated & free), (self.gid, allocated & free)
        assert allocated | free == set(range(1, self.n_blocks)), \
            f"group {self.gid}: leaked pages"
        for p, r in self._ref.items():
            assert r >= 1, (self.gid, p, r)
            held = slot_holds.get(p, 0)
            assert r >= held, (self.gid, p, r, held)
            if external is not None:
                assert r == held + external.get(p, 0), \
                    (self.gid, p, r, held)
        for p in slot_holds:
            assert p in self._ref, (self.gid, p)
        assert self.available_blocks() >= 0, \
            f"group {self.gid}: over-committed reservations"
        # the §17 ledger invariant: a reserved slot's net draws (draws
        # minus retirement drawdowns) never exceed its promise — a
        # violation means admission under-reserved and a later append
        # may hit MemoryError mid-flight
        for s, r in self._reserved.items():
            assert self._drawn[s] <= r, (
                f"group {self.gid}: slot {s} drew {self._drawn[s]} "
                f"net pages against a reservation of {r}"
            )


class PagedKVCache:
    def __init__(
        self,
        cfg: ModelConfig,
        n_slots: int,
        max_len: int,
        block_size: int = 16,
        n_blocks: int = 0,
        window_retirement: bool = True,
        kv_dtype: str = "bf16",
        prefill_chunk: int = 0,
        group_pool_slack: Optional[int] = None,
        group_blocks=None,
        device="cuda",
    ):
        """`max_len`: max tokens (prompt + generated) any slot may hold.
        `n_blocks=0` sizes each group's pool for full occupancy: scratch
        + every slot at max_len. `window_retirement=False` keeps the
        layer-major structure but disables sliding-window page
        retirement and window-aware attach skipping — the
        lockstep-residency baseline the benchmarks compare against
        (tokens are bit-identical either way: retired columns are
        window-masked). `kv_dtype` ("bf16" | "int8", DESIGN.md §16)
        selects the pool storage; "int8" adds per-page per-(layer,head)
        f32 scale stacks (`k_scales`/`v_scales`, [L, n_blocks, KV])
        managed alongside the pools — COW copies a page's scale rows
        with its KV rows. The pools live on `device` (default the card;
        raises when none is present).

        Long-context trio (DESIGN.md §17). `prefill_chunk > 0` is the
        caller's promise that no single append spans more than that
        many tokens (the scheduler's chunked prefill; rounded up to a
        block multiple). Under that promise every retiring group's net
        live draws per slot are bounded by
        `ceil(window/bs) + group_pool_slack` (the slack defaults to
        `chunk_blocks + 1`, the exact worst case over block
        alignments), so `reserve_slot` caps its promise at that bound
        instead of `ceil(total/bs)` and retirement draws the ledger
        back down. `group_blocks` sizes pools per group: None keeps the
        uniform `n_blocks` everywhere, "auto" sizes each retiring
        windowed group at `1 + n_slots * live_bound` (requires
        `prefill_chunk > 0` — a single-shot long prefill would
        transiently overflow the shrunk pool), and a `{gid: n_blocks}`
        dict pins explicit per-group sizes. The stacked device arrays
        are still allocated at the LARGEST group's size; the per-group
        bookkeeping refuses to draw past each group's own budget."""
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.block_size = block_size
        self.max_blocks_per_slot = -(-max_len // block_size)
        if prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {prefill_chunk}"
            )
        #: max tokens one append may span (0 = unbounded, block-rounded)
        self.prefill_chunk = (
            -(-prefill_chunk // block_size) * block_size
            if prefill_chunk else 0
        )
        chunk_blocks = self.prefill_chunk // block_size if \
            self.prefill_chunk else 1
        if group_pool_slack is None:
            # a span of c*bs tokens can straddle c+1 blocks, and the
            # just-retired boundary block may still be partially live:
            # ceil(W/bs) + chunk_blocks + 1 is the exact worst case
            group_pool_slack = chunk_blocks + 1
        if group_pool_slack < 1:
            raise ValueError(
                f"group_pool_slack must be >= 1, got {group_pool_slack}"
            )
        self.group_pool_slack = int(group_pool_slack)
        uniform = n_blocks or 1 + n_slots * self.max_blocks_per_slot
        if uniform < 2:
            raise ValueError(
                f"n_blocks={uniform} leaves no page beyond scratch"
            )
        # NOTE: an explicit n_blocks below one slot's worst case
        # (1 + max_blocks_per_slot) is legal since §17: admission
        # reserves before any draw, so an over-large request is refused
        # with the per-group deficit diagnostic instead of hitting
        # MemoryError mid-flight — and under chunked prefill the
        # live-bounded promise may still fit where the worst case
        # cannot, which is the whole point of retirement-aware sizing.
        self.window_retirement = window_retirement
        capacity = self.max_blocks_per_slot * block_size
        groups = layer_attn_groups(cfg, capacity)
        if group_blocks == "auto" and not self.prefill_chunk:
            raise ValueError(
                "group_blocks='auto' requires prefill_chunk > 0: "
                "without chunked appends a long prefill transiently "
                "allocates its full windowed table and overflows a "
                "live-bound-sized pool"
            )

        def _live_bound(window: Optional[int]) -> Optional[int]:
            if (window is None or not window_retirement
                    or not self.prefill_chunk):
                return None
            return min(
                self.max_blocks_per_slot,
                -(-window // block_size) + self.group_pool_slack,
            )

        def _pool_blocks(gid: int, bound: Optional[int]) -> int:
            if isinstance(group_blocks, dict):
                return int(group_blocks.get(gid, uniform))
            if group_blocks == "auto" and bound is not None:
                return min(uniform, 1 + n_slots * bound)
            return uniform

        self.pools = []
        for gid, (window, layers) in enumerate(groups):
            bound = _live_bound(window)
            self.pools.append(LayerPagePool(
                gid, layers, window, n_slots, self.max_blocks_per_slot,
                _pool_blocks(gid, bound), block_size,
                retire=window_retirement, live_bound=bound,
            ))
        #: physical page rows in the stacked device arrays (= the
        #: largest group's id space; smaller groups use a prefix of it)
        self.n_blocks = max(p.n_blocks for p in self.pools)
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"kv_dtype must be 'bf16' or 'int8', got {kv_dtype!r}"
            )
        self.kv_dtype = kv_dtype
        if kv_dtype == "int8":
            (self.k_pages, self.v_pages,
             self.k_scales, self.v_scales) = init_paged_pool(
                cfg, self.n_blocks, block_size, kv_dtype, self.device
            )
        else:
            self.k_pages, self.v_pages = init_paged_pool(
                cfg, self.n_blocks, block_size, device=self.device
            )
            self.k_scales = self.v_scales = None
        self.lengths = np.zeros((n_slots,), np.int32)
        #: per-group layer rows of the stacked pools, as a device index
        self._group_layers = [
            torch.tensor(p.layers, dtype=torch.int64, device=self.device)
            for p in self.pools
        ]

    def group_layer_index(self, gid: int) -> torch.Tensor:
        """Layer rows of group `gid` in the stacked pools."""
        return self._group_layers[gid]

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    # -- group-0 conveniences (single-group configs == the old API) --------

    @property
    def n_free(self) -> int:
        """Free blocks in the most-pressured group (the admission
        bottleneck); equals the old single-pool count when the config
        has one attention pattern."""
        return min(p.n_free for p in self.pools)

    @property
    def pages_allocated(self) -> int:
        return sum(p.pages_allocated for p in self.pools)

    @property
    def cow_events(self) -> int:
        return sum(p.cow_events for p in self.pools)

    @property
    def pages_retired(self) -> int:
        return sum(p.pages_retired for p in self.pools)

    def owned_blocks(self, slot: int, group: int = 0) -> Tuple:
        """The group's logical-block-aligned page list (None = dead)."""
        return tuple(self.pools[group]._owned[slot])

    def refcount(self, page: int, group: int = 0) -> int:
        return self.pools[group].refcount(page)

    def retain(self, page: int, group: int = 0) -> None:
        self.pools[group].retain(page)

    def release(self, page: int, group: int = 0) -> None:
        self.pools[group].release(page)

    # -- invariants --------------------------------------------------------

    def check_invariants(self, external_refs=None) -> None:
        """Every group's pages are free XOR refcounted and each refcount
        equals slot holds + external (prefix-index) retains.
        `external_refs` is `PrefixIndex.page_refs()` — per-group
        `{gid: {page: count}}` — or a flat `{page: count}` dict, which
        addresses group 0 (the single-group configs of the older
        tests)."""
        per_group: Optional[Dict[int, Dict[int, int]]]
        if external_refs is None:
            per_group = None
        elif all(isinstance(v, dict) for v in external_refs.values()):
            per_group = dict(external_refs)
        else:
            per_group = {0: external_refs}
        for pool in self.pools:
            ext = None if per_group is None else per_group.get(
                pool.gid, {}
            )
            pool.check_invariants(self.lengths, ext)

    # -- admission control -------------------------------------------------

    def _blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def available_blocks(self) -> int:
        """Unpromised free blocks in the most-pressured group."""
        return min(p.available_blocks() for p in self.pools)

    def draws_for(self, n_tokens: int, n_shared: int = 0,
                  n_cow: int = 0,
                  live_bound: Optional[int] = None) -> int:
        """Pool draws a slot needs in ONE group for `n_tokens` positions
        when `n_shared` of its blocks arrive dead-or-attached and up to
        `n_cow` attached pages may be copy-on-written — the single home
        of the admission draw formula. (Dead window-skipped blocks cost
        no draw, exactly like attached ones, so callers fold both into
        `n_shared`.) `live_bound` is the group's retirement-aware cap
        (DESIGN.md §17): with chunked appends the slot's NET draws never
        exceed it — retirement recycles a page for (almost) every new
        one — so the reservation promises `min(worst_case, live_bound)`
        instead of the full `ceil(total/bs)`."""
        base = self._blocks_for(n_tokens) - n_shared
        if live_bound is not None:
            base = min(base, live_bound)
        return max(base, 0) + n_cow

    def _group_counts(self, value) -> Dict[int, int]:
        if isinstance(value, dict):
            return {p.gid: value.get(p.gid, 0) for p in self.pools}
        return {p.gid: int(value) for p in self.pools}

    def reserve_slot(self, slot: int, n_tokens: int, n_shared=0,
                     n_cow=0) -> bool:
        """Admission control: promise `slot` enough pool draws in EVERY
        layer group for `n_tokens` total positions. `n_shared`/`n_cow`
        are ints (same in every group) or per-group dicts (a prefix hit
        attaches different page counts per group — window-skipped blocks
        count as shared). All-or-nothing: either every group can honor
        its promise or nothing is reserved."""
        need = self._blocks_for(n_tokens)
        if need > self.max_blocks_per_slot:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens exceed max "
                f"{self.max_blocks_per_slot * self.block_size}"
            )
        shared = self._group_counts(n_shared)
        cow = self._group_counts(n_cow)
        draws = {
            p.gid: self.draws_for(n_tokens, shared[p.gid], cow[p.gid],
                                  live_bound=p.live_bound)
            for p in self.pools
        }
        if any(
            p.available_blocks() < draws[p.gid] for p in self.pools
        ):
            return False
        for p in self.pools:
            p._reserved[slot] = draws[p.gid]
            p._drawn[slot] = 0
        return True

    def reserve_deficits(self, n_tokens: int, n_shared=0,
                         n_cow=0) -> Dict[int, int]:
        """Per-group draw deficits (> 0 only) a failed reservation faces
        right now — what eviction must free, group by group."""
        shared = self._group_counts(n_shared)
        cow = self._group_counts(n_cow)
        out = {}
        for p in self.pools:
            d = self.draws_for(n_tokens, shared[p.gid], cow[p.gid],
                               live_bound=p.live_bound)
            short = d - p.available_blocks()
            if short > 0:
                out[p.gid] = short
        return out

    # -- slot lifecycle ----------------------------------------------------

    def plan_attach(self, block_pages: List[Dict[int, int]],
                    n_cached: int) -> Optional[Dict[int, Tuple[int, List[int]]]]:
        """Window-aware per-group attach plan for a prefix hit
        (DESIGN.md §12). `block_pages[j]` maps gid -> physical page of
        the hit chain's j-th block (missing when that group never owned
        the block — the publisher window-skipped it). For each group the
        plan attaches only blocks a suffix query (earliest position
        `n_cached`) can still see; fully-dead leading blocks are skipped
        — the group neither bumps their refcounts nor lists them.
        Returns None when some group is MISSING a block it still needs
        (shrinking the hit only widens the window's reach, so the hit is
        rejected outright)."""
        nbh = len(block_pages)
        out: Dict[int, Tuple[int, List[int]]] = {}
        for p in self.pools:
            j0 = min(p.dead_blocks(n_cached), nbh)
            pages = []
            for j in range(j0, nbh):
                page = block_pages[j].get(p.gid)
                if page is None:
                    return None
                pages.append(page)
            out[p.gid] = (j0, pages)
        return out

    def attach_plan_counts(
        self, plan: Dict[int, Tuple[int, List[int]]], needs_cow: bool
    ) -> Tuple[Dict[int, int], Dict[int, int]]:
        """(n_shared, n_cow) per group for `reserve_slot`: skipped dead
        blocks and attached pages both avoid a draw; the mid-page COW
        only hits groups that actually attached the final block."""
        shared = {g: j0 + len(pages) for g, (j0, pages) in plan.items()}
        cow = {
            g: int(needs_cow and bool(pages))
            for g, (j0, pages) in plan.items()
        }
        return shared, cow

    def attach_chain(self, slot: int,
                     plan: Dict[int, Tuple[int, List[int]]]) -> None:
        """Apply a `plan_attach` result: per group, refcount-bump and map
        the attached pages; the slot must be empty."""
        for p in self.pools:
            j0, pages = plan[p.gid]
            p.attach(slot, j0, pages)

    def free_slot(self, slot: int) -> None:
        """Drop the slot's reference on each of its pages in every group;
        exclusively owned pages recycle, shared ones live on."""
        for p in self.pools:
            p.free_slot(slot)
        self.lengths[slot] = 0

    def slot_block_pages(self, slot: int, block_idx: int) -> Dict[int, int]:
        """gid -> physical page backing the slot's `block_idx`-th block
        (groups whose block is dead/unallocated are absent) — what the
        prefix index publishes."""
        out = {}
        for p in self.pools:
            owned = p._owned[slot]
            if block_idx < len(owned) and owned[block_idx] is not None:
                out[p.gid] = owned[block_idx]
        return out

    # -- copy-on-write / append -------------------------------------------

    def begin_append(self, slot: int, start: int, n_tokens: int) -> None:
        """Prepare `slot` for writes covering [start, start + n_tokens):
        per group — retire blocks dead for the earliest remaining query
        (`start`), grow capacity, and COW any shared page in the touched
        range. Must run host-side BEFORE the device write so the device
        table snapshot already points at live, writable pages."""
        if n_tokens <= 0:
            return
        bs = self.block_size
        first = start // bs
        last = (start + n_tokens - 1) // bs
        for p in self.pools:
            p.retire(slot, start)
            p.grow(slot, start, start + n_tokens)
            for j in range(first, min(last + 1, len(p._owned[slot]))):
                if p._owned[slot][j] is not None:
                    p.make_writable(self, slot, j)

    # -- device views ------------------------------------------------------
    # Fresh copies (`torch.tensor` copies — `torch.from_numpy` would alias
    # the host tables this object mutates in place).

    def device_block_tables(
        self, scratch_slots: Sequence[int] = ()
    ) -> torch.Tensor:
        """Each layer's group table: [L, n_slots, max_blocks] int32, or
        the single shared [n_slots, max_blocks] table when the config
        has one attention pattern (broadcast by the model entry points).
        `scratch_slots` rows are presented all-scratch — the scheduler
        parks mid-chunked-prefill slots there so the batched decode's
        unconditional KV write cannot touch their half-written pages."""
        if len(self.pools) == 1:
            full = np.array(self.pools[0].block_table)
            if len(scratch_slots):
                full[list(scratch_slots)] = SCRATCH_PAGE
        else:
            full = np.zeros(
                (self.cfg.n_layers, self.n_slots, self.max_blocks_per_slot),
                np.int32,
            )
            for p in self.pools:
                full[list(p.layers)] = p.block_table
            if len(scratch_slots):
                full[:, list(scratch_slots)] = SCRATCH_PAGE
        return torch.tensor(full, dtype=torch.int32, device=self.device)

    def device_block_starts(
        self, scratch_slots: Sequence[int] = ()
    ) -> torch.Tensor:
        """Each layer's first live block: [L, n_slots] int32, or
        [n_slots] for a single-group config. `scratch_slots` walk from
        block 0, matching their all-scratch table rows."""
        if len(self.pools) == 1:
            full = np.array(self.pools[0].first_block)
            if len(scratch_slots):
                full[list(scratch_slots)] = 0
        else:
            full = np.zeros((self.cfg.n_layers, self.n_slots), np.int32)
            for p in self.pools:
                full[list(p.layers)] = p.first_block
            if len(scratch_slots):
                full[:, list(scratch_slots)] = 0
        return torch.tensor(full, dtype=torch.int32, device=self.device)

    def device_positions(
        self, scratch_slots: Sequence[int] = ()
    ) -> torch.Tensor:
        """Per-slot write index for the next decode step (= length);
        `scratch_slots` present position 0, exactly an idle slot."""
        pos = np.array(self.lengths)
        if len(scratch_slots):
            pos[list(scratch_slots)] = 0
        return torch.tensor(pos, dtype=torch.int32, device=self.device)


    def slot_occupancy(self) -> float:
        """Fraction of non-scratch pages allocated, worst group — each
        group against ITS OWN pool size (per-group sizing, §17)."""
        return max(
            1.0 - p.n_free / max(p.n_blocks - 1, 1)
            for p in self.pools
        )

    def free_state(self) -> Tuple[int, ...]:
        """Per-group free counts — the progress snapshot the scheduler's
        deadlock detector compares across ticks."""
        return tuple(p.n_free for p in self.pools)

    def pool_gauges(self) -> List[Dict[str, object]]:
        """Per-group gauge sample for the telemetry layer: one dict per
        pool, keys matching the `pool_*{group=g}` metric family.
        `resident_page_bytes` is the group's allocated pages times its
        layers times `page_layer_bytes` (scale rows included) — the KV
        the group pins, not the stacked arrays' allocation, which holds
        every layer at the largest group's size."""
        plb = self.page_layer_bytes
        return [
            {
                "gid": p.gid,
                "free_pages": p.n_free,
                "unreserved_pages": p.available_blocks(),
                "allocated_pages": p.allocated_pages(),
                "shared_refs": p.extra_refs(),
                "cow_events": p.cow_events,
                "pages_retired": p.pages_retired,
                "pages_allocated_total": p.pages_allocated,
                "resident_page_bytes":
                    len(p.layers) * p.allocated_pages() * plb,
            }
            for p in self.pools
        ]

    # -- bucketed dispatch inputs (DESIGN.md §11-§12) ----------------------

    def bucket_needs(self, eff_lengths,
                     slots: Optional[Sequence[int]] = None
                     ) -> List[np.ndarray]:
        """Per-group live walk-entry counts for one launch: a global
        group walks `ceil(len/bs)` table entries per slot, a windowed
        group only its live trailing blocks (`... - first_block`). Feed
        to `kernels.ops.bucket_args_grouped`."""
        eff = np.maximum(np.asarray(eff_lengths).reshape(-1), 1)
        blocks = np.minimum(
            -(-eff // self.block_size), self.max_blocks_per_slot
        )
        idx = np.arange(self.n_slots) if slots is None else np.asarray(
            list(slots)
        )
        return [
            np.maximum(blocks - p.first_block[idx], 1)
            for p in self.pools
        ]

    # -- accounting ----------------------------------------------------------

    @property
    def page_layer_bytes(self) -> int:
        """Bytes of ONE page in ONE layer (K + V) at the pool's actual
        itemsize; int8 pools add the two f32 scale rows."""
        _, _, bs, kvh, hd = self.k_pages.shape
        data = 2 * bs * kvh * hd * self.k_pages.element_size()
        if self.quantized:
            data += 2 * kvh * self.k_scales.element_size()
        return data

    def resident_page_bytes(self) -> int:
        """KV bytes pinned right now: each group's allocated pages occupy
        that group's layer rows only."""
        plb = self.page_layer_bytes
        return sum(
            len(p.layers) * p.allocated_pages() * plb for p in self.pools
        )

    def peak_resident_page_bytes(self) -> int:
        """High-water mark of `resident_page_bytes` over the cache's
        lifetime, per group at draw time — so it catches a single-shot
        long prefill that allocates its whole windowed table and retires
        most of it within one tick."""
        plb = self.page_layer_bytes
        return sum(
            len(p.layers) * p.peak_allocated * plb for p in self.pools
        )

    def provisioned_page_bytes(self) -> int:
        """KV capacity provisioned (pool budget, not residency): each
        group's non-scratch page budget times its layer rows."""
        plb = self.page_layer_bytes
        return sum(
            len(p.layers) * (p.n_blocks - 1) * plb for p in self.pools
        )

    def lockstep_equiv_page_bytes(self) -> int:
        """What the same logical state would pin if one logical page
        occupied a row in every layer's pool. A non-retiring group never
        retires or skips, so its allocation count is the logical page
        count; with no such group (an all-windowed stack with retirement
        on) this falls back to the largest group's count, a lower
        bound."""
        plb = self.page_layer_bytes
        anchors = [p for p in self.pools if p.retire_window is None]
        logical = max(
            p.allocated_pages() for p in (anchors or self.pools)
        )
        return self.k_pages.shape[0] * logical * plb

    def cross_layer_dedup_stats(self) -> Dict[str, int]:
        """Physical-copy accounting across the layer-major pools:

          allocated_pages          group-pages currently allocated
                                   (summed over groups)
          shared_pages             group-pages with refcount > 1
          extra_refs               sum(refcount - 1) over groups: copies
                                   sharing avoided materializing
          physical_page_copies     per-layer physical copies stored
                                   = sum_g n_layers_g * allocated_g
          deduped_page_copies      per-layer copies sharing avoided
                                   = sum_g n_layers_g * extra_g
          page_layer_bytes         bytes of ONE page in ONE layer (K+V)
          physical_bytes / deduped_bytes    the two above in bytes
          retired_pages            window-retired pages (lifetime)
          resident_bytes           physical_bytes (alias)
          lockstep_equiv_bytes     the same state under lockstep page ids
        """
        plb = self.page_layer_bytes
        n_layers = self.k_pages.shape[0]
        allocated = sum(p.allocated_pages() for p in self.pools)
        shared = sum(
            sum(1 for r in p._ref.values() if r > 1) for p in self.pools
        )
        extra = sum(p.extra_refs() for p in self.pools)
        phys = sum(
            len(p.layers) * p.allocated_pages() for p in self.pools
        )
        dedup = sum(len(p.layers) * p.extra_refs() for p in self.pools)
        return {
            "n_layers": int(n_layers),
            "n_groups": len(self.pools),
            "allocated_pages": allocated,
            "shared_pages": shared,
            "extra_refs": extra,
            "physical_page_copies": phys,
            "deduped_page_copies": dedup,
            "page_layer_bytes": plb,
            "physical_bytes": phys * plb,
            "deduped_bytes": dedup * plb,
            "retired_pages": self.pages_retired,
            "resident_bytes": phys * plb,
            "lockstep_equiv_bytes": self.lockstep_equiv_page_bytes(),
        }
