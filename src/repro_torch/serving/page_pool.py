"""Host-side KV page-pool allocator and cross-request prefix cache (numpy
only).

The port's copy of ``repro/serving/page_pool.py``. The device holds one
pool of pages per attention layer; this class owns the ids: which pages
are free and how many holders reference each live page. A request's
candidates ``share()`` its full prompt pages and copy only the partial
tail page, so prompt KV is resident once per request. Misuse (double
free, free of an unallocated or reserved page, over-allocation, an
unknown shard) raises instead of corrupting the table.

**Sharded pools** (``num_shards > 1``, mesh serving): the page-id space
splits into ``num_shards`` equal contiguous ranges, one per data shard,
the boundaries a page-axis sharding of the device pools uses. Each shard
has its own LIFO free list, frontier counters and quarantine page (the
first page of its range, ``quarantine_page(shard)``: idle slots of the
shard point their block tables there and their dead writes land there;
it is never allocated or freed). ``alloc``/``stage_frontier``/
``ensure_free`` take the shard; ``free``/``share`` route by page id. A
full shard never borrows another's pages. With one shard every page id
is the unsharded pool's: page 0 is the quarantine page and allocation
pops ascending from page 1.

The optional **cross-request prefix cache** (``prefix_cache=True``)
extends that sharing across requests: page-aligned prompt prefixes are
content-hashed into a chain (page i's key commits to pages 0..i's
tokens), and the cache holds one refcount on each registered page, so a
finished request's prompt KV stays resident. A later request whose key
stream starts with the same bytes shares those pages and prefills only
its suffix. Pages held by nobody but the cache are *evictable*: ``alloc``
reclaims them least-recently-used leaf first under pressure (from the
allocating shard's range only), so chains stay prefix-closed and the
cache never starves live traffic. With a ``kv_byte_budget`` the pool
also evicts cached-only pages whenever resident KV bytes exceed it.
"""
from __future__ import annotations

import hashlib
import heapq
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class PagePoolError(RuntimeError):
    pass


def prefix_page_keys(tokens, page_size: int) -> List[str]:
    """Content-hash chain over the page-aligned prefix of ``tokens``
    (``page_pool.py:58``): key[i] = sha256(key[i-1] || tokens of page i),
    so equal keys mean equal bytes for the whole prefix through page i.
    Only full pages get keys."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int64))
    keys: List[str] = []
    prev = b""
    for i in range(len(toks) // page_size):
        d = hashlib.sha256(
            prev + toks[i * page_size:(i + 1) * page_size].tobytes()).digest()
        keys.append(d.hex())
        prev = d
    return keys


class _Node:
    __slots__ = ("page", "parent", "children", "tick")

    def __init__(self, page: int, parent: Optional[str], tick: int):
        self.page = page
        self.parent = parent
        self.children = 0
        self.tick = tick


class PrefixCache:
    """Content-hash chain -> resident KV page map (``page_pool.py:75``).

    The cache holds exactly one pool refcount per registered page.
    Invariants (``PagePool.check``): every cached page is live, and every
    node's parent is cached. Victims come from a min-tick heap with lazy
    deletion: each touch pushes a fresh (tick, key) entry and ``evict``
    skips entries whose tick no longer matches their node. A sharded pool
    keeps one such heap per shard beside the global one (entries in both,
    lazy deletion resolves each), so a shard's eviction never sifts
    through its siblings' entries."""

    def __init__(self, pool: "PagePool"):
        self.pool = pool
        self._nodes: Dict[str, _Node] = {}
        self._tick = 0
        self._heap: List[Tuple[int, str]] = []
        self._heap_sh: List[List[Tuple[int, str]]] = \
            [[] for _ in range(pool.num_shards)] if pool.num_shards > 1 \
            else []
        self._evictable_memo = None
        self.probes = 0        # lookup calls
        self.hits = 0          # pages reused across requests
        self.misses = 0        # lookups that fell short of a full hit
        self.hit_tokens = 0    # prefill tokens skipped
        self.insertions = 0
        self.evictions = 0

    @property
    def cached_pages(self) -> int:
        return len(self._nodes)

    def _push(self, tick: int, key: str, page: int):
        heapq.heappush(self._heap, (tick, key))
        if self._heap_sh:
            heapq.heappush(self._heap_sh[self.pool.shard_of(page)],
                           (tick, key))
        # every touch leaves a stale entry behind; rebuild from the live
        # nodes once stale entries dominate
        if len(self._heap) > 64 + 4 * len(self._nodes):
            self._compact()

    def _compact(self):
        live = [(node.tick, k) for k, node in self._nodes.items()]
        self._heap = list(live)
        heapq.heapify(self._heap)
        for s in range(len(self._heap_sh)):
            h = [(t, k) for t, k in live
                 if self.pool.shard_of(self._nodes[k].page) == s]
            heapq.heapify(h)
            self._heap_sh[s] = h

    def _touch(self, key: str, node: _Node):
        node.tick = self._tick
        self._push(self._tick, key, node.page)

    def match_and_hold(self, keys: Sequence[str]) -> List[int]:
        """Pages of the longest cached prefix of ``keys``, with one holder
        added per page (the caller's request hold) and the chain
        LRU-touched. Empty on a complete miss."""
        self._tick += 1
        self.probes += 1
        pages: List[int] = []
        for k in keys:
            node = self._nodes.get(k)
            if node is None:
                break
            pages.append(node.page)
        if len(pages) < len(keys):
            self.misses += 1
        if not pages:
            return []
        self.pool.share(pages)
        for k in keys[:len(pages)]:
            self._touch(k, self._nodes[k])
        self.hits += len(pages)
        self.hit_tokens += len(pages) * self.pool.page_size
        return pages

    def insert(self, keys: Sequence[str], pages: Sequence[int]):
        """Register ``pages`` under ``keys`` (chain order, equal length).
        New nodes take one cache hold; keys already cached keep their
        page (the first writer's)."""
        if len(keys) != len(pages):
            raise PagePoolError(f"insert of {len(keys)} keys for "
                                f"{len(pages)} pages")
        self._tick += 1
        parent: Optional[str] = None
        for k, page in zip(keys, pages):
            node = self._nodes.get(k)
            if node is None:
                self.pool.share([page])
                node = _Node(int(page), parent, self._tick)
                self._nodes[k] = node
                self._push(self._tick, k, node.page)
                if parent is not None:
                    self._nodes[parent].children += 1
                self.insertions += 1
            else:
                self._touch(k, node)
            parent = k
        # under a byte budget the oldest cached chains pay for the newest
        self.pool.enforce_byte_budget()

    # -- eviction -------------------------------------------------------
    def _evictable_per_shard(self) -> List[int]:
        """Pages of each shard the cache could hand back right now: every
        node but those some request still holds and their ancestors,
        counted in one walk."""
        pps = self.pool.pages_per_shard
        count = [0] * self.pool.num_shards
        blocked: set = set()
        for k, node in self._nodes.items():
            count[node.page // pps] += 1
            if self.pool.refcount(node.page) > 1:
                p: Optional[str] = k
                while p is not None and p not in blocked:
                    blocked.add(p)
                    held = self._nodes[p]
                    count[held.page // pps] -= 1
                    p = held.parent
        return count

    def evictable_pages(self, shard: Optional[int] = None) -> int:
        """Pages the cache could hand back to the pool right now (of
        ``shard``'s range, when given), memoised on the pool's mutation
        counter."""
        key = (self.pool.mutations, self._tick, len(self._nodes))
        if self._evictable_memo is None or self._evictable_memo[0] != key:
            self._evictable_memo = (key, self._evictable_per_shard())
        per_shard = self._evictable_memo[1]
        return sum(per_shard) if shard is None else per_shard[shard]

    def _evict_node(self, key: str, node: _Node):
        self._nodes.pop(key)
        if node.parent is not None and node.parent in self._nodes:
            parent = self._nodes[node.parent]
            parent.children -= 1
            if parent.children == 0:
                # the parent is the chain's next victim: make sure a live
                # heap entry exists for it
                self._push(parent.tick, node.parent, parent.page)
        self.pool.free([node.page])
        self.evictions += 1

    def evict(self, n: int, shard: Optional[int] = None) -> int:
        """Free up to ``n`` cached pages, least-recently-used leaves first
        (a chain shrinks from its deep end); with ``shard``, only pages of
        that shard's range, from its own heap. Returns pages freed."""
        heap = self._heap_sh[shard] if shard is not None and self._heap_sh \
            else self._heap
        freed = 0
        stash: List[Tuple[int, str]] = []
        # our own frees would re-enter the byte-budget enforcement
        prev, self.pool._enforcing = self.pool._enforcing, True
        try:
            while freed < n and heap:
                tick, key = heapq.heappop(heap)
                node = self._nodes.get(key)
                if node is None or node.tick != tick:
                    continue                   # stale entry
                if node.children > 0 or self.pool.refcount(node.page) > 1 \
                        or (shard is not None and
                            self.pool.shard_of(node.page) != shard):
                    stash.append((tick, key))  # alive, not evictable now
                    continue
                self._evict_node(key, node)
                freed += 1
        finally:
            self.pool._enforcing = prev
        for entry in stash:
            heapq.heappush(heap, entry)
        return freed

    def drop_all(self):
        """Release every cache hold. Pages still held by live requests
        survive with their remaining holders."""
        prev, self.pool._enforcing = self.pool._enforcing, True
        try:
            for node in self._nodes.values():
                self.pool.free([node.page])
        finally:
            self.pool._enforcing = prev
        self._nodes.clear()
        self._heap.clear()
        for h in self._heap_sh:
            h.clear()

    def reset_stats(self) -> None:
        """Zero the counters; the cached chains stay resident."""
        self.probes = self.hits = self.misses = 0
        self.hit_tokens = self.insertions = self.evictions = 0

    def stats(self) -> dict:
        return {"probes": self.probes, "hits": self.hits,
                "misses": self.misses, "hit_tokens": self.hit_tokens,
                "cached_pages": self.cached_pages,
                "insertions": self.insertions, "evictions": self.evictions}


class PagePool:
    def __init__(self, num_pages: int, page_size: int, *,
                 prefix_cache: bool = False, num_shards: int = 1,
                 kv_byte_budget: int = 0):
        if num_shards < 1:
            raise PagePoolError(f"num_shards={num_shards}")
        if num_pages % num_shards:
            raise PagePoolError(f"pool of {num_pages} pages not divisible "
                                f"into {num_shards} shards")
        self.pages_per_shard = num_pages // num_shards
        if self.pages_per_shard <= 1:
            raise PagePoolError(
                f"pool of {num_pages} pages has no allocatable pages "
                f"(reserved=1 per shard x {num_shards} shards)")
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_shards = num_shards
        # per-shard LIFO free lists: recently freed pages are reused
        # first; the initial pop order is ascending from the page after
        # the shard's quarantine page
        self._free_sh: List[List[int]] = [
            list(range(lo + self.pages_per_shard - 1, lo, -1))
            for lo in range(0, num_pages, self.pages_per_shard)]
        self._refs = np.zeros(num_pages, np.int64)
        self.max_in_use = 0
        # bumped on every refcount change (the evictable-page memo's key)
        self.mutations = 0
        # frontier accounting (macro-step serving): pages handed out ahead
        # of the device loop and how many came back unconsumed, in all and
        # per shard
        self.frontier_staged = 0
        self.frontier_returned = 0
        self.frontier_peak_stage = 0
        self._frontier_staged_sh = np.zeros(num_shards, np.int64)
        self._frontier_returned_sh = np.zeros(num_shards, np.int64)
        self.prefix: Optional[PrefixCache] = \
            PrefixCache(self) if prefix_cache else None
        # byte-budgeted residency: once the engine reports its bytes per
        # page, every change that could leave resident KV above the budget
        # evicts cached-only pages until it fits or none is evictable
        # (live holds are never evicted)
        self.kv_byte_budget = int(kv_byte_budget)
        self.bytes_per_page = 0
        self.budget_evictions = 0
        self._enforcing = False

    @property
    def in_use(self) -> int:
        return int(np.count_nonzero(self._refs))

    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._free_sh)

    def free_pages_in(self, shard: int) -> int:
        return len(self._free_sh[shard])

    def shard_of(self, page: int) -> int:
        return int(page) // self.pages_per_shard

    def page_offset(self, shard: int) -> int:
        """The first page id of shard ``shard``'s range: a rank holding
        the shard keeps page ``page_offset(shard) + i`` at its pool's
        index i."""
        return shard * self.pages_per_shard

    def quarantine_page(self, shard: int = 0) -> int:
        """The reserved page idle slots of ``shard`` point at."""
        return shard * self.pages_per_shard

    def _is_reserved(self, page: int) -> bool:
        return page % self.pages_per_shard == 0

    def refcount(self, page: int) -> int:
        return int(self._refs[page])

    # -- byte budget ------------------------------------------------------
    def set_bytes_per_page(self, bpp: int) -> None:
        """The engine's resident bytes per page (values and quantization
        scales over every layer); activates ``kv_byte_budget``."""
        self.bytes_per_page = int(bpp)
        self.enforce_byte_budget()

    @property
    def resident_kv_bytes(self) -> int:
        return self.in_use * self.bytes_per_page

    def over_budget_pages(self) -> int:
        """Pages that must leave residency to meet the byte budget."""
        if not (self.kv_byte_budget and self.bytes_per_page):
            return 0
        over = self.resident_kv_bytes - self.kv_byte_budget
        return -(-over // self.bytes_per_page) if over > 0 else 0

    def enforce_byte_budget(self) -> int:
        """Evict cached-only pages until resident KV bytes fit the budget
        or nothing cached is evictable; re-entrant calls are no-ops.
        Returns pages evicted."""
        if self._enforcing or self.prefix is None:
            return 0
        n = self.over_budget_pages()
        if n == 0:
            return 0
        self._enforcing = True
        try:
            freed = self.prefix.evict(n)
        finally:
            self._enforcing = False
        self.budget_evictions += freed
        return freed

    # ------------------------------------------------------------------
    def evictable(self, shard: Optional[int] = None) -> int:
        """Pages the prefix cache could give back under pressure (of
        ``shard``'s range, when given)."""
        return 0 if self.prefix is None else \
            self.prefix.evictable_pages(shard)

    def ensure_free(self, n: int, shard: Optional[int] = None):
        """Evict cached-only pages until at least ``n`` pages are free (of
        ``shard``, when given), so that reservations rest on pages a later
        prefix hit cannot pin again."""
        def have():
            return self.free_pages if shard is None \
                else self.free_pages_in(shard)
        if n <= have():
            return
        if self.prefix is not None:
            self.prefix.evict(n - have(), shard)
        if n > have():
            raise PagePoolError(
                f"cannot secure {n} free pages ({have()} free, "
                f"{self.evictable(shard)} evictable of {self.num_pages}"
                f"{'' if shard is None else f', shard {shard}'})")

    def alloc(self, n: int = 1, shard: int = 0) -> List[int]:
        """Take ``n`` fresh pages (refcount 1 each) from ``shard``'s range,
        evicting that shard's cached-only prefix pages under pressure."""
        if n < 0:
            raise PagePoolError(f"alloc({n})")
        if not 0 <= shard < self.num_shards:
            raise PagePoolError(f"alloc on unknown shard {shard}")
        free = self._free_sh[shard]
        if n > len(free) and self.prefix is not None:
            self.prefix.evict(n - len(free),
                              shard if self.num_shards > 1 else None)
        if n > len(free):
            raise PagePoolError(
                f"out of KV pages: need {n}, have {len(free)} free of "
                f"{self.pages_per_shard} in shard {shard} (pool in use: "
                f"{self.in_use}/{self.num_pages}) — raise num_pages or "
                "reduce slots/cache_len")
        pages = [free.pop() for _ in range(n)]
        self._refs[pages] = 1
        self.mutations += 1
        self.max_in_use = max(self.max_in_use, self.in_use)
        self.enforce_byte_budget()
        return pages

    def share(self, pages: Iterable[int]):
        """Add one holder to each page."""
        for p in pages:
            if self._refs[p] <= 0:
                raise PagePoolError(f"share of unallocated page {p}")
            self._refs[p] += 1
        self.mutations += 1

    def free(self, pages: Iterable[int]):
        """Drop one holder from each page; pages reaching zero return to
        their own shard's free list."""
        for p in pages:
            if self._is_reserved(p):
                raise PagePoolError(f"free of reserved page {p}")
            if self._refs[p] <= 0:
                raise PagePoolError(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free_sh[self.shard_of(p)].append(p)
        self.mutations += 1
        # a dropped hold may have unblocked pages the budget waits for
        self.enforce_byte_budget()

    def stage_frontier(self, n: int, shard: int = 0) -> List[int]:
        """Reserve ``n`` pages of ``shard`` as a slot's decode frontier:
        pages the macro-step loop may advance into without the host. The
        caller keeps the consumed prefix and hands the rest back through
        ``return_frontier``."""
        pages = self.alloc(n, shard)
        self.frontier_staged += n
        self.frontier_peak_stage = max(self.frontier_peak_stage, n)
        self._frontier_staged_sh[shard] += n
        return pages

    def return_frontier(self, pages: Iterable[int]):
        pages = list(pages)
        self.free(pages)
        self.frontier_returned += len(pages)
        for p in pages:
            self._frontier_returned_sh[self.shard_of(p)] += 1

    def check(self):
        """Conservation: every non-reserved page is either on its own
        shard's free list (ref 0) or held (ref > 0), never both or
        neither; cached chains point at live pages and are
        prefix-closed."""
        free = set()
        for s, fl in enumerate(self._free_sh):
            fs = set(fl)
            if len(fs) != len(fl):
                raise PagePoolError(f"shard {s} free list has duplicates")
            for p in fs:
                if self.shard_of(p) != s:
                    raise PagePoolError(
                        f"page {p} on shard {s} free list but belongs to "
                        f"shard {self.shard_of(p)}")
                if self._is_reserved(p):
                    raise PagePoolError(f"reserved page {p} on free list")
            free |= fs
        for p in range(self.num_pages):
            if self._is_reserved(p):
                continue
            if (self._refs[p] > 0) == (p in free):
                raise PagePoolError(
                    f"page {p} violates conservation (refs={self._refs[p]}, "
                    f"on_free_list={p in free})")
        if self.prefix is not None:
            for k, node in self.prefix._nodes.items():
                if self._refs[node.page] <= 0:
                    raise PagePoolError(
                        f"prefix cache maps {k[:8]} to dead page {node.page}")
                if node.parent is not None and \
                        node.parent not in self.prefix._nodes:
                    raise PagePoolError(
                        f"prefix chain broken at {k[:8]} (parent evicted)")

    def reset_stats(self) -> None:
        """Zero the frontier and high-water telemetry; allocation state and
        cached chains stay. ``max_in_use`` restarts from the current
        occupancy."""
        self.frontier_staged = self.frontier_returned = 0
        self.frontier_peak_stage = 0
        self._frontier_staged_sh[:] = 0
        self._frontier_returned_sh[:] = 0
        self.max_in_use = self.in_use
        self.budget_evictions = 0
        if self.prefix is not None:
            self.prefix.reset_stats()

    def stats(self) -> dict:
        s = {"num_pages": self.num_pages, "page_size": self.page_size,
             "in_use": self.in_use, "free": self.free_pages,
             "max_in_use": self.max_in_use,
             "frontier_staged": self.frontier_staged,
             "frontier_returned": self.frontier_returned,
             "frontier_peak_stage": self.frontier_peak_stage}
        if self.kv_byte_budget:
            s["kv_byte_budget"] = self.kv_byte_budget
            s["budget_evictions"] = self.budget_evictions
            if self.bytes_per_page:
                s["resident_kv_bytes"] = self.resident_kv_bytes
        if self.num_shards > 1:
            s["num_shards"] = self.num_shards
            s["shards"] = [{
                "free": self.free_pages_in(i),
                "frontier_staged": int(self._frontier_staged_sh[i]),
                "frontier_returned": int(self._frontier_returned_sh[i]),
            } for i in range(self.num_shards)]
        if self.prefix is not None:
            s["prefix_cache"] = self.prefix.stats()
        return s
