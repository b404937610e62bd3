"""The port's sharded ``PagePool`` in lockstep with the reference's.

One seeded random sequence of operations drives the port's pool and the
JAX package's numpy ``repro.serving.page_pool.PagePool`` side by side,
with 1, 2 and 4 shards, the prefix cache off and on (on: under a byte
budget too): alloc, share, free, frontier staging and returns,
``ensure_free``, prefix-cache lookups, insertions and evictions (global
and per shard), ``drop_all``, ``reset_stats`` and the operations that
must fail (an unknown shard, over-allocation, a double free, a free of a
quarantine page, a share of a free page). After every operation the two
pools return the same page ids, raise the same errors, report the same
stats, evictable counts and free pages per shard, and both pass
``check()``. With one shard the page ids are the unsharded pool's.
"""
import numpy as np
import pytest

from repro.serving.page_pool import PagePool as JPool
from repro.serving.page_pool import PagePoolError as JError
from repro_torch.serving.page_pool import (PagePool, PagePoolError,
                                           prefix_page_keys)
from torch_ranks import _one_torch_thread  # noqa: F401

PS = 4


def _both(a, b, fn):
    """``fn`` on both pools: the same result, or the same error."""
    out = []
    for pool, err in ((a, PagePoolError), (b, JError)):
        try:
            out.append(("ok", fn(pool)))
        except err as e:
            out.append(("error", str(e)))
    assert out[0] == out[1], out
    return out[0]


def _same(a, b):
    a.check()
    b.check()
    assert a.stats() == b.stats()
    for s in [None] + list(range(a.num_shards)):
        assert a.evictable(s) == b.evictable(s)
    for s in range(a.num_shards):
        assert a.free_pages_in(s) == b.free_pages_in(s)
        assert a.quarantine_page(s) == b.quarantine_page(s)
    assert a.in_use == b.in_use and a.max_in_use == b.max_in_use


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("cache", ["off", "on", "budget"])
def test_lockstep_with_reference(shards, cache):
    rng = np.random.default_rng(100 * shards + len(cache))
    n_pages = 7 * shards
    kw = dict(prefix_cache=cache != "off", num_shards=shards,
              kv_byte_budget=100 * (n_pages // 2) if cache == "budget" else 0)
    a, b = PagePool(n_pages, PS, **kw), JPool(n_pages, PS, **kw)
    if cache == "budget":
        a.set_bytes_per_page(100)
        b.set_bytes_per_page(100)
    held, staged = [], []
    bases = [rng.integers(2, 50, 6 * PS) for _ in range(3)]
    for _ in range(500):
        op = int(rng.integers(10))
        shard = int(rng.integers(-1, shards + 1))       # edges included
        if op == 0:
            n = int(rng.integers(0, 5))
            r = _both(a, b, lambda p: p.alloc(n, shard))
            if r[0] == "ok":
                held += r[1]
        elif op == 1 and held:
            pages = [held[int(i)] for i in
                     rng.integers(len(held), size=int(rng.integers(1, 3)))]
            _both(a, b, lambda p: p.share(pages))
            held += pages
        elif op == 2 and held:
            i = int(rng.integers(len(held)))
            _both(a, b, lambda p: p.free([held[i]]))
            held.pop(i)
        elif op == 3:
            n = int(rng.integers(0, 3))
            r = _both(a, b, lambda p: p.stage_frontier(n, shard))
            if r[0] == "ok":
                staged.append(r[1])
        elif op == 4 and staged:
            pages = staged.pop(int(rng.integers(len(staged))))
            k = int(rng.integers(len(pages) + 1))
            held += pages[:k]                   # the consumed prefix
            _both(a, b, lambda p: p.return_frontier(pages[k:]))
        elif op == 5:
            n = int(rng.integers(0, 6))
            sh = None if shard < 0 or shard >= shards else shard
            _both(a, b, lambda p: p.ensure_free(n, sh))
        elif op == 6 and a.prefix is not None:
            # a request: hold the cached prefix of its prompt, seed the
            # rest of its full pages on one shard and register them
            base = bases[int(rng.integers(len(bases)))]
            toks = base[:int(rng.integers(1, len(base) + 1))]
            keys = prefix_page_keys(toks, PS)
            r = _both(a, b, lambda p: p.prefix.match_and_hold(keys))
            pages = r[1]
            sh = int(rng.integers(shards))
            r = _both(a, b, lambda p: p.alloc(len(keys) - len(pages), sh))
            if r[0] == "ok":
                pages = pages + r[1]
                _both(a, b, lambda p: p.prefix.insert(keys, pages))
            held += pages
        elif op == 7 and a.prefix is not None:
            n = int(rng.integers(0, 4))
            sh = None if shard < 0 or shard >= shards else shard
            _both(a, b, lambda p: p.prefix.evict(n, sh))
        elif op == 8:
            # misuse: a quarantine page, a page nobody holds
            q = a.quarantine_page(int(rng.integers(shards)))
            _both(a, b, lambda p: p.free([q]))
            idle = [p for p in range(n_pages)
                    if a.refcount(p) == 0 and p % (n_pages // shards)]
            if idle:
                p0 = idle[int(rng.integers(len(idle)))]
                _both(a, b, lambda p: p.free([p0]))
                _both(a, b, lambda p: p.share([p0]))
        elif op == 9:
            if rng.random() < 0.1 and a.prefix is not None:
                _both(a, b, lambda p: p.prefix.drop_all())
            if rng.random() < 0.2:
                _both(a, b, lambda p: p.reset_stats())
        _same(a, b)
    # drain: every hold released leaves only the cache's pages in use
    for pages in staged:
        _both(a, b, lambda p: p.return_frontier(pages))
    _both(a, b, lambda p: p.free(held))
    if a.prefix is not None:
        _both(a, b, lambda p: p.prefix.drop_all())
    _same(a, b)
    assert a.in_use == 0


def test_shard_layout():
    """Page-id ranges, quarantine pages and pop order per shard; one
    shard keeps the unsharded ids (page 0 quarantined, pops from 1)."""
    one = PagePool(6, PS)
    assert (one.quarantine_page(), one.alloc(2)) == (0, [1, 2])
    pool = PagePool(12, PS, num_shards=3)
    assert [pool.quarantine_page(s) for s in range(3)] == [0, 4, 8]
    assert pool.alloc(2, 1) == [5, 6]
    assert [pool.shard_of(p) for p in (0, 3, 4, 11)] == [0, 0, 1, 2]
    assert [pool.free_pages_in(s) for s in range(3)] == [3, 1, 3]
    for bad in (lambda: PagePool(7, PS, num_shards=2),
                lambda: PagePool(4, PS, num_shards=4),
                lambda: PagePool(4, PS, num_shards=0),
                lambda: pool.alloc(2, 1), lambda: pool.alloc(1, 3),
                lambda: pool.free([4])):
        with pytest.raises(PagePoolError):
            bad()
