"""Host-side KV page-pool allocator (numpy only).

The port's copy of ``repro/serving/page_pool.py`` for one unsharded pool
without the cross-request prefix cache (those belong to later slices of
the port). The device holds one pool of pages per attention layer; this
class owns the ids: which pages are free and how many holders reference
each live page. A request's candidates ``share()`` its full prompt pages
and copy only the partial tail page, so prompt KV is resident once per
request. Page 0 is the quarantine page idle slots write into; it is never
allocated or freed. Misuse raises instead of corrupting the table.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np


class PagePoolError(RuntimeError):
    pass


class PagePool:
    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise PagePoolError(f"pool of {num_pages} pages has no "
                                "allocatable page beside the quarantine page")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list: recently freed pages are reused first; the
        # initial pop order is ascending from page 1
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs = np.zeros(num_pages, np.int64)
        self.max_in_use = 0
        # frontier accounting (macro-step serving): pages handed out ahead
        # of the device loop and how many came back unconsumed
        self.frontier_staged = 0
        self.frontier_returned = 0
        self.frontier_peak_stage = 0

    @property
    def in_use(self) -> int:
        return int(np.count_nonzero(self._refs))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def quarantine_page(self) -> int:
        return 0

    def alloc(self, n: int = 1) -> List[int]:
        """Take ``n`` fresh pages (refcount 1 each)."""
        if n < 0:
            raise PagePoolError(f"alloc({n})")
        if n > len(self._free):
            raise PagePoolError(
                f"out of KV pages: need {n}, have {len(self._free)} free of "
                f"{self.num_pages} (in use: {self.in_use}) — raise "
                "num_pages or reduce slots/cache_len")
        pages = [self._free.pop() for _ in range(n)]
        self._refs[pages] = 1
        self.max_in_use = max(self.max_in_use, self.in_use)
        return pages

    def share(self, pages: Iterable[int]):
        """Add one holder to each page."""
        for p in pages:
            if self._refs[p] <= 0:
                raise PagePoolError(f"share of unallocated page {p}")
            self._refs[p] += 1

    def free(self, pages: Iterable[int]):
        """Drop one holder from each page; pages reaching zero return to
        the free list."""
        for p in pages:
            if p == 0:
                raise PagePoolError("free of the quarantine page")
            if self._refs[p] <= 0:
                raise PagePoolError(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)

    def stage_frontier(self, n: int) -> List[int]:
        """Reserve ``n`` pages as a slot's decode frontier: pages the
        macro-step loop may advance into without the host. The caller
        keeps the consumed prefix and hands the rest back through
        ``return_frontier``."""
        pages = self.alloc(n)
        self.frontier_staged += n
        self.frontier_peak_stage = max(self.frontier_peak_stage, n)
        return pages

    def return_frontier(self, pages: Iterable[int]):
        pages = list(pages)
        self.free(pages)
        self.frontier_returned += len(pages)

    def check(self):
        """Conservation: every non-reserved page is either free (ref 0) or
        held (ref > 0), never both or neither."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise PagePoolError("free list has duplicates")
        if 0 in free:
            raise PagePoolError("quarantine page on the free list")
        for p in range(1, self.num_pages):
            if (self._refs[p] > 0) == (p in free):
                raise PagePoolError(
                    f"page {p} violates conservation (refs={self._refs[p]}, "
                    f"on_free_list={p in free})")

    def stats(self) -> dict:
        return {"num_pages": self.num_pages, "page_size": self.page_size,
                "in_use": self.in_use, "free": self.free_pages,
                "max_in_use": self.max_in_use,
                "frontier_staged": self.frontier_staged,
                "frontier_returned": self.frontier_returned,
                "frontier_peak_stage": self.frontier_peak_stage}
