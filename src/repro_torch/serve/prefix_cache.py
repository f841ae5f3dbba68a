"""Prefix radix index: shared-prefix KV dedup for the paged cache —
counterpart of `repro.serve.prefix_cache` (pure host code, the
reference's line for line).

A radix trie over full KV pages: each node is one `block_size`-token
block of a previously served prompt, keyed by its tokens, and records
one physical page per layer group (`pages: {gid: page}`). A lookup walks
the prompt block by block from the root, so it can only hand out pages
whose whole token history matches. The index holds one retain per
(group, page) it maps; writes into shared pages go through the cache's
copy-on-write, so published bytes never change. When admission fails
for want of pages, `evict` releases index-only pages by value density
(hits per retained layer-byte), oldest first among equals.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .paged_cache import PagedKVCache


class _Node:
    __slots__ = ("key", "pages", "parent", "children", "stamp", "hits")

    def __init__(self, key, pages: Dict[int, int],
                 parent: Optional["_Node"]):
        self.key = key                  # tuple of block_size token ids
        self.pages = pages              # gid -> physical page of the block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.stamp = 0                  # last-touched tick
        self.hits = 0                   # lookup matches (eviction scoring)


class PrefixIndex:
    """Radix/trie index from full-page token prefixes to per-group pages.

    `max_retained_fraction` caps how much of EACH group's pool the index
    may pin: the index never holds retains on more than that fraction of
    a group's usable (non-scratch) pages. `publish` enforces it — once a
    group is at the cap it evicts an index-only page to make room, and
    stops publishing when nothing is evictable — so a prefix-heavy trace
    cannot starve admission of its working pages. The default (1.0)
    preserves the uncapped behavior."""

    def __init__(self, block_size: int, max_retained_fraction: float = 1.0):
        if not 0.0 <= max_retained_fraction <= 1.0:
            raise ValueError(
                f"max_retained_fraction must be in [0, 1], got "
                f"{max_retained_fraction}"
            )
        self.block_size = block_size
        self.max_retained_fraction = max_retained_fraction
        self.root = _Node(key=None, pages={}, parent=None)
        self._clock = 0
        #: retains currently held, per layer group
        self.retained_by_group: Dict[int, int] = collections.defaultdict(int)
        # stats (surfaced by benchmarks/prefix_bench.py). hits/lookups
        # count ADMITTED requests — the scheduler bumps them once per
        # admission, not once per (possibly retried) lookup attempt
        self.lookups = 0
        self.hits = 0                   # admitted requests with >= 1 page hit
        self.cached_tokens_served = 0   # prompt tokens skipped via hits
        self.evicted_pages = 0

    @property
    def retained_pages(self) -> int:
        """Total (group, page) retains the index currently holds."""
        return sum(self.retained_by_group.values())

    def page_cap(self, cache: PagedKVCache) -> int:
        """Max pages the index may retain in EACH group's pool."""
        return int(self.max_retained_fraction * (cache.n_blocks - 1))

    def stats(self) -> Dict[str, int]:
        """Gauge sample for the telemetry layer (`pool_prefix_*`)."""
        return {
            "retained_pages": self.retained_pages,
            "nodes": len(self),
            "hits": self.hits,
            "lookups": self.lookups,
            "cached_tokens_served": self.cached_tokens_served,
            "evicted_pages": self.evicted_pages,
        }

    # -- helpers -----------------------------------------------------------

    def block_keys(self, tokens) -> List[Tuple[int, ...]]:
        """The prompt's full-block trie keys. Callers that probe the same
        prompt repeatedly (a queued request re-tried every admission
        tick) should compute this once and pass it to
        `lookup`/`publish` — the tuple construction is the O(prompt)
        part of a probe."""
        toks = np.asarray(tokens).reshape(-1)
        bs = self.block_size
        return [
            tuple(int(x) for x in toks[i: i + bs])
            for i in range(0, (len(toks) // bs) * bs, bs)
        ]

    def __len__(self) -> int:
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n

    def page_refs(self) -> Dict[int, Dict[int, int]]:
        """gid -> {page: index retains} (for invariant checking)."""
        refs: Dict[int, Dict[int, int]] = collections.defaultdict(
            lambda: collections.defaultdict(int)
        )
        stack = [self.root]
        while stack:
            node = stack.pop()
            for c in node.children.values():
                for gid, page in c.pages.items():
                    refs[gid][page] += 1
                stack.append(c)
        return {g: dict(d) for g, d in refs.items()}

    # -- lookup / publish --------------------------------------------------

    def lookup_chain(self, tokens,
                     keys: Optional[List[Tuple[int, ...]]] = None
                     ) -> List[_Node]:
        """Longest full-page prefix match: the matched node chain for the
        leading blocks of `tokens` whose entire history is cached. The
        caller turns it into a per-group attach plan
        (`PagedKVCache.plan_attach`) and decides how many blocks to
        actually share (`split_prompt` keeps one token to prefill)."""
        self._clock += 1
        node, chain = self.root, []
        for key in keys if keys is not None else self.block_keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.stamp = self._clock
            child.hits += 1
            chain.append(child)
            node = child
        return chain

    def split_prompt(self, tokens, pages) -> Tuple[int, bool]:
        """Given a `lookup`/`lookup_chain` result, return
        `(n_cached, needs_cow)`: `n_cached` prompt tokens are served from
        the shared pages and the suffix `tokens[n_cached:]` must still be
        prefilled. At least one token is always left to prefill (the
        model needs a forward pass to produce next-token logits), so a
        hit covering the *entire* prompt recomputes its final token —
        whose KV write lands mid-page in the last shared page, the
        copy-on-write case (`needs_cow`)."""
        t = int(np.asarray(tokens).reshape(-1).shape[0])
        n_cached = min(len(pages) * self.block_size, t - 1)
        needs_cow = bool(n_cached % self.block_size)
        return n_cached, needs_cow

    def _make_room(self, cache: PagedKVCache, gid: int, protect) -> bool:
        """Cap enforcement for one group: displace an index-only page
        when the group sits at its retained cap."""
        cap = self.page_cap(cache)
        if self.retained_by_group[gid] < cap:
            return True
        return bool(self.evict(cache, {gid: 1}, protect=protect))

    def publish(self, tokens, cache: PagedKVCache, slot: int,
                keys: Optional[List[Tuple[int, ...]]] = None) -> int:
        """Insert the prompt's full-page blocks, backed by `slot`'s
        per-group pages, after its prefill completed. Already-indexed
        blocks keep their pages (first writer wins — the bytes are
        equivalent by construction) but may be FILLED IN for groups the
        first writer lacked (its window had skipped the block; a shorter
        publisher still owns it). Groups whose block is dead in the slot
        are simply absent from the node — a windowed group never retains
        out-of-window prefix bytes. Each newly-indexed (group, page) gets
        one index retain. Returns the number of pages newly retained."""
        self._clock += 1
        node, added = self.root, 0
        path = {self.root}
        if keys is None:
            keys = self.block_keys(tokens)
        for j, key in enumerate(keys):
            avail = cache.slot_block_pages(slot, j)
            child = node.children.get(key)
            if child is None:
                if not avail:
                    break
                # cap enforcement per group: displace the lowest-value
                # index-only page. The nodes already walked this publish
                # are protected — evicting the chain the new node hangs
                # off would attach it to a detached parent and leak its
                # retains
                if not all(
                    self._make_room(cache, gid, path) for gid in avail
                ):
                    # at the retained cap and nothing evictable: stop
                    # publishing — blocks already inserted stay (their
                    # history is complete)
                    break
                child = _Node(key=key, pages=dict(avail), parent=node)
                node.children[key] = child
                for gid, page in avail.items():
                    cache.retain(page, gid)
                    self.retained_by_group[gid] += 1
                    added += 1
            else:
                for gid, page in avail.items():
                    if gid in child.pages:
                        continue
                    if not self._make_room(cache, gid, path | {child}):
                        continue
                    child.pages[gid] = page
                    cache.retain(page, gid)
                    self.retained_by_group[gid] += 1
                    added += 1
            child.stamp = self._clock
            node = child
            path.add(node)
        return added

    # -- eviction ----------------------------------------------------------

    def _node_evictable(self, cache: PagedKVCache, node: _Node,
                        protect) -> bool:
        return node not in protect and all(
            cache.refcount(page, gid) == 1
            for gid, page in node.pages.items()
        )

    def _prunable_counts(self, cache: PagedKVCache,
                         protect=frozenset()) -> Dict[int, int]:
        """Pages per group that eviction could release right now: nodes
        whose every page is index-only, not protected, and whose entire
        subtree is likewise prunable (a retained or protected descendant
        pins every ancestor in place)."""
        counts: Dict[int, int] = collections.defaultdict(int)

        def walk(node: _Node) -> bool:
            all_ok = True
            for c in node.children.values():
                all_ok = walk(c) and all_ok
            if node is self.root:
                return all_ok
            ok = all_ok and self._node_evictable(cache, node, protect)
            if ok:
                for gid in node.pages:
                    counts[gid] += 1
            return ok

        walk(self.root)
        return counts

    def _evict_score(self, cache: PagedKVCache, node: _Node):
        """Value density: hits per retained layer-byte. A cold node that
        pins many layers' bytes (a global-group page in a deep stack)
        scores lowest and goes first; equal-density ties fall back to
        oldest-stamp (the pre-§12 pure LRU)."""
        layer_weight = sum(
            len(cache.pools[gid].layers) for gid in node.pages
        )
        return ((1 + node.hits) / max(layer_weight, 1), node.stamp)

    def evict(self, cache: PagedKVCache, n_pages,
              protect=frozenset()) -> int:
        """Release index-only pages until the demand is met, or release
        NOTHING when it cannot be (partially draining the index would
        destroy hot prefixes without unblocking the caller's admission).

        `n_pages` is a per-group demand dict `{gid: pages}` (the
        scheduler's reserve deficits) or an int, which addresses group 0
        (single-group configs — the pre-§12 signature). Victim nodes
        release ALL their group pages; they are chosen lowest
        value-density first (`_evict_score`), leaves before the parents
        they expose. Returns total pages released (0 when unsatisfiable).
        `protect` nodes are never victims (publish shields the chain it
        is standing on)."""
        needs: Dict[int, int] = (
            dict(n_pages) if isinstance(n_pages, dict) else {0: n_pages}
        )
        needs = {g: n for g, n in needs.items() if n > 0}
        if not needs:
            return 0
        prunable = self._prunable_counts(cache, protect)
        if any(prunable.get(g, 0) < n for g, n in needs.items()):
            return 0
        released: Dict[int, int] = collections.defaultdict(int)
        total = 0

        def satisfied():
            return all(released[g] >= n for g, n in needs.items())

        def useful(node):
            return any(
                released[g] < needs.get(g, 0) for g in node.pages
            )

        def drop(victim):
            nonlocal total
            del victim.parent.children[victim.key]
            for gid, page in victim.pages.items():
                cache.release(page, gid)
                released[gid] += 1
                self.retained_by_group[gid] -= 1
                total += 1

        while not satisfied():
            victims = sorted(
                (
                    n for n in self._leaves()
                    if self._node_evictable(cache, n, protect)
                ),
                key=lambda n: self._evict_score(cache, n),
            )
            if not victims:
                break
            # only victims holding a page in a still-unsatisfied group
            # count as progress — evicting others would wipe unrelated
            # (possibly hot) prefixes as collateral. When no leaf is
            # useful, the needed pages sit on interior nodes (the
            # prunable pre-check proved they exist): drop ONE lowest-
            # value leaf to expose its parent, then rescan.
            progressed = False
            for victim in victims:
                if satisfied():
                    break
                if not useful(victim):
                    continue
                drop(victim)
                progressed = True
            if not satisfied() and not progressed:
                drop(victims[0])
        self.evicted_pages += total
        return total

    def _leaves(self) -> List[_Node]:
        out, stack = [], list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                out.append(node)
        return out
