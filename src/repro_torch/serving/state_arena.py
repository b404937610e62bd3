"""Fixed-stride slot-state arena: the recurrent-family sibling of PagePool.

A copy of ``repro/serving/state_arena.py`` (host bookkeeping in numpy,
so the port keeps its own copy rather than import the JAX package).

Recurrent and hybrid architectures carry O(1)-per-slot decode state
(SSD state + conv tails, RG-LRU h + conv, windowed KV rings) instead of
O(context) pageable KV. The serving engine still wants the PagePool
disciplines for the *prompt* copies of that state — a bounded number of
prefilled-but-not-yet-admitted rows, refcounted holds, exact
conservation at teardown, and telemetry — so this arena manages integer
row ids of a fixed-size device-side state buffer exactly the way
PagePool manages page ids of the KV pools: per-shard LIFO free lists,
refcounts, fail-fast errors on double-free/over-alloc, and a ``check()``
conservation audit.

The arena itself is host-side bookkeeping only. The device buffer it
indexes is a ``model.make_cache(num_rows, ...)`` pytree owned by the
engine; a "row" is index ``r`` along every leaf's batch axis (axis 1 of
every leaf but ``pos``, see ``models/transformer.py``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


class StateArenaError(RuntimeError):
    """Misuse of the arena: double free, freeing an unallocated row,
    over-allocation beyond a shard's capacity."""


class StateArena:
    """Refcounted fixed-stride row allocator with shard-local free lists."""

    def __init__(self, num_rows: int, num_shards: int = 1):
        if num_rows <= 0 or num_shards <= 0 or num_rows % num_shards:
            raise ValueError(
                f"num_rows={num_rows} must be a positive multiple of "
                f"num_shards={num_shards}")
        self.num_rows = num_rows
        self.num_shards = num_shards
        self.rows_per_shard = num_rows // num_shards
        # LIFO free lists (pop/append at the tail) keep recently-freed
        # rows hot, mirroring PagePool.
        self._free: List[List[int]] = [
            list(range(s * self.rows_per_shard,
                       (s + 1) * self.rows_per_shard))[::-1]
            for s in range(num_shards)]
        self._ref = np.zeros(num_rows, np.int64)
        self.alloc_count = 0
        self.free_count = 0
        self.max_in_use = 0
        self.sizing_stalls = 0   # times the engine deferred prefill on 0 free

    # -- queries ------------------------------------------------------------
    @property
    def free_rows(self) -> int:
        return sum(len(f) for f in self._free)

    def free_rows_in(self, shard: int) -> int:
        return len(self._free[shard])

    @property
    def in_use(self) -> int:
        return self.num_rows - self.free_rows

    def shard_of(self, row: int) -> int:
        return row // self.rows_per_shard

    def best_shard(self) -> int:
        """The shard with the most free rows (load-balancing default)."""
        return int(max(range(self.num_shards),
                       key=lambda s: len(self._free[s])))

    # -- alloc/free ---------------------------------------------------------
    def alloc(self, n: int, shard: int = 0) -> List[int]:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if len(self._free[shard]) < n:
            raise StateArenaError(
                f"shard {shard} has {len(self._free[shard])} free state "
                f"rows, need {n} (arena: {self.num_rows} rows over "
                f"{self.num_shards} shards)")
        rows = [self._free[shard].pop() for _ in range(n)]
        for r in rows:
            self._ref[r] = 1
        self.alloc_count += n
        self.max_in_use = max(self.max_in_use, self.in_use)
        return rows

    def share(self, rows: List[int]) -> None:
        """Add a reference to already-held rows."""
        for r in rows:
            if self._ref[r] <= 0:
                raise StateArenaError(f"share of free state row {r}")
            self._ref[r] += 1

    def free(self, rows: List[int]) -> None:
        """Drop one reference per row; rows hitting zero return to their
        shard's free list."""
        for r in rows:
            if not (0 <= r < self.num_rows):
                raise StateArenaError(f"free of out-of-range row {r}")
            if self._ref[r] <= 0:
                raise StateArenaError(f"double free of state row {r}")
            self._ref[r] -= 1
            if self._ref[r] == 0:
                self._free[self.shard_of(r)].append(r)
                self.free_count += 1

    # -- invariants / telemetry ---------------------------------------------
    def check(self) -> None:
        """Conservation audit: every row is exactly once free or held,
        free lists are duplicate-free and shard-local."""
        seen = set()
        for s, fl in enumerate(self._free):
            for r in fl:
                if r in seen:
                    raise StateArenaError(f"row {r} on a free list twice")
                seen.add(r)
                if self.shard_of(r) != s:
                    raise StateArenaError(
                        f"row {r} (shard {self.shard_of(r)}) on shard "
                        f"{s}'s free list")
                if self._ref[r] != 0:
                    raise StateArenaError(
                        f"free-listed row {r} has refcount {self._ref[r]}")
        held = int((self._ref > 0).sum())
        if held + len(seen) != self.num_rows:
            raise StateArenaError(
                f"conservation violated: {held} held + {len(seen)} free "
                f"!= {self.num_rows} rows")

    def stats(self) -> Dict[str, object]:
        return {
            "num_rows": self.num_rows,
            "num_shards": self.num_shards,
            "free_rows": self.free_rows,
            "in_use": self.in_use,
            "max_in_use": self.max_in_use,
            "alloc_count": self.alloc_count,
            "free_count": self.free_count,
            "sizing_stalls": self.sizing_stalls,
            "free_per_shard": [len(f) for f in self._free],
        }

    def reset_stats(self) -> None:
        """Zero the counters (same ownership contract as
        ``PagePool.reset_stats``): occupancy is state, not a counter —
        ``max_in_use`` restarts from the current occupancy."""
        self.alloc_count = 0
        self.free_count = 0
        self.sizing_stalls = 0
        self.max_in_use = self.in_use
