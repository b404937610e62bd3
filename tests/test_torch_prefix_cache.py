"""The port's cross-request prefix cache against the JAX package's.

The port keeps its own copy of the reference's page pool with the prefix
cache (``repro_torch/serving/page_pool.py``), its suffix prefill
(``Model.prefill_suffix``) and the engine's prefix paths. Here, on the CPU
with the reference's weights carried over by ``params_from_jax``:

* page keys are the reference's sha-256 chain, for text streams and for
  image requests' pseudo-token streams;
* one random sequence of probes, inserts, allocations, frees and
  evictions gives both pools the same pages, refcounts, free lists,
  chains and ``stats()``, with and without a byte budget;
* the suffix prefill against cached context gives the reference's logits,
  hidden state and suffix K/V within 1e-4 abs + 1e-4 rel (fp32);
* engines with ``prefix_cache=True`` (``paged`` and ``paged_cuda``, whose
  kernels run their plain versions on the CPU) serve shared-prefix text
  prompts, and image requests with repeated images from an int8 pool under
  a byte budget that forces evictions, with the reference engine's
  streams, prefill token counts and ``kv_stats()["prefix_cache"]``
  (``ReferenceNoise`` gives the reference's Gumbel draws);
* on ``paged`` the cache changes no token: streams with it on equal those
  with it off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.config import CAMDConfig as JCAMD
from repro.config import PagedKVConfig as JPaged
from repro.config import SamplingConfig as JSampling
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JEngine
from repro.serving.page_pool import PagePool as JPagePool
from repro.serving.page_pool import PagePoolError as JPagePoolError
from repro.serving.page_pool import prefix_page_keys as jprefix_page_keys
from repro_torch import config as tconfig
from repro_torch.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.page_pool import PagePool, PagePoolError
from repro_torch.serving.page_pool import prefix_page_keys
# the reference engine's Gumbel draws; the fixtures: the tiny model pair,
# one torch thread (autouse), the reduced granite pair with binding
# capacity and the reduced llava pair
from test_torch_engine_camd import (ReferenceNoise,  # noqa: F401
                                    _one_torch_thread, tiny)
from test_torch_moe import granite_tight  # noqa: F401
from test_torch_multimodal import llava  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
CAMD = dict(samples_per_round=2, max_rounds=3, min_samples=2,
            max_clusters=8)


# ---------------------------------------------------------------------------
# page keys and the pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["text", "image"])
@pytest.mark.parametrize("page_size", [4, 8, 16])
def test_prefix_page_keys_equal_reference(kind, page_size):
    """The key chain over a text prompt, and over an image request's
    stream (pseudo-tokens from an image digest ahead of the prompt, as
    both engines build it), equals the reference's; a stream that shares
    the first pages shares exactly their keys."""
    rng = np.random.default_rng(page_size)
    prompt = rng.integers(2, 1000, 61).astype(np.int32)
    stream = np.asarray(prompt, np.int64)
    if kind == "image":
        ne = 12
        digest = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        rep = (digest * (ne * 8 // len(digest) + 1))[:ne * 8]
        stream = np.concatenate([np.frombuffer(rep, np.int64), stream])
    keys = prefix_page_keys(stream, page_size)
    assert keys == jprefix_page_keys(stream, page_size)
    assert len(keys) == len(stream) // page_size
    other = stream.copy()
    other[2 * page_size + 1] += 1
    assert prefix_page_keys(other, page_size)[:2] == keys[:2]
    assert prefix_page_keys(other, page_size)[2] != keys[2]


# (op, chain id, length): "req" probes a chain, allocates its uncached
# pages, registers it and keeps or drops the request hold; "evict" and
# "alloc" press the pool; "release" drops the oldest kept hold
OPS = st.lists(st.tuples(
    st.sampled_from(["req", "req", "keep", "evict", "alloc", "release"]),
    st.integers(0, 4), st.integers(1, 7)), min_size=1, max_size=30)


def _drive(pool, ops):
    """Drive a pool as the engine does; returns the trace of every
    operation's outcome and state."""
    held, trace = [], []
    cache = pool.prefix
    for op, cid, n in ops:
        try:
            if op in ("req", "keep"):
                keys = [f"c{cid}/{i}" for i in range(n)]
                pages = cache.match_and_hold(keys)
                try:
                    pages = pages + pool.alloc(n - len(pages))
                except (PagePoolError, JPagePoolError):
                    pool.free(pages)
                    raise
                cache.insert(keys, pages)
                if op == "keep":
                    held.append(pages)
                else:
                    pool.free(pages)
                out = pages
            elif op == "evict":
                out = cache.evict(n)
            elif op == "alloc":
                out = pool.alloc(n)
                held.append(out)
            else:
                out = held.pop(0) if held else []
                pool.free(out)
        except (PagePoolError, JPagePoolError):
            out = "error"
        pool.check()
        trace.append((out, pool._refs.tolist(), pool.free_pages,
                      pool.stats(), pool.evictable(),
                      sorted((k, nd.page, nd.parent, nd.children, nd.tick)
                             for k, nd in cache._nodes.items())))
    for pages in held:
        pool.free(pages)
    cache.drop_all()
    pool.check()
    trace.append(pool.in_use)
    return trace


@pytest.mark.parametrize("budget", [0, 5])
@given(ops=OPS)
@settings(max_examples=40, deadline=None)
def test_pool_ops_equal_reference(budget, ops):
    """The same operations on both pools give the same pages, refcounts,
    free lists, chains, evictions and ``stats()``; with a byte budget of
    ``budget`` pages the pool evicts cached-only pages alike. Everything
    is returned at the end."""
    pools = []
    for cls in (JPagePool, PagePool):
        pool = cls(24, 4, prefix_cache=True, kv_byte_budget=budget * 100)
        pool.set_bytes_per_page(100)
        pools.append(pool)
    exp, got = (_drive(p, ops) for p in pools)
    assert got == exp
    assert got[-1] == 0


def test_pool_misuse_raises():
    pool = PagePool(6, 4, prefix_cache=True)
    pages = pool.alloc(2)
    for bad in (lambda: pool.prefix.insert(["a"], pages),
                lambda: pool.ensure_free(6), lambda: pool.free([0])):
        with pytest.raises(PagePoolError):
            bad()
    pool.prefix.insert(["a", "b"], pages)
    pool.free(pages)
    assert pool.evictable() == 2 and pool.in_use == 2
    pool.ensure_free(5)                      # evicts both, leaf first
    assert pool.prefix.evictions == 2 and pool.in_use == 0
    pool.check()


# ---------------------------------------------------------------------------
# suffix prefill
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small(small_model):
    jcfg, jmodel, jparams = small_model
    cfg = tconfig.ModelConfig(**{f.name: getattr(jcfg, f.name) for f in
                                 dataclasses.fields(tconfig.ModelConfig)})
    model = build_model(cfg, torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg))
    return jcfg, jmodel, jparams, model


@pytest.mark.parametrize("pair,start", [("tiny", 8), ("small", 16)])
def test_prefill_suffix_equals_reference(pair, start, request):
    """Both packages prefill the same prompt's first ``start`` positions,
    then its 11-token suffix against that K/V as context: logits, hidden
    state and the suffix K/V seeded at rows [0, 11) agree within 1e-4,
    ``pos`` is start + 11, and the port's suffix equals its own whole
    prefill's last row."""
    jcfg, jmodel, jparams, model = request.getfixturevalue(pair)
    rng = np.random.default_rng(start)
    toks = rng.integers(2, jcfg.vocab_size, (2, start + 11)).astype(np.int32)
    _, _, jc = jmodel.prefill(jparams, jnp.asarray(toks[:, :start]),
                              jmodel.make_cache(2, 32))
    jctx = {"super": tuple((e["k"][:, :, :start], e["v"][:, :, :start])
                           for e in jc["super"]), "tail": ()}
    jlg, jh, jcache = jmodel.prefill_suffix(
        jparams, jnp.asarray(toks[:, start:]), jmodel.make_cache(2, 32),
        jctx, jnp.int32(start))
    with torch.inference_mode():
        t = torch.as_tensor(toks, dtype=torch.long)
        _, _, c = model.prefill(t[:, :start], model.make_cache(2, 32))
        ctx = {"k": c["k"][:, :, :start].clone(),
               "v": c["v"][:, :, :start].clone()}
        lg, h, cache = model.prefill_suffix(t[:, start:],
                                            model.make_cache(2, 32), ctx,
                                            start)
        wlg, _, _ = model.prefill(t, model.make_cache(2, 32))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(lg.numpy(), wlg.numpy(), **TOL)
    (je,) = jcache["super"]
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name][:, :, :11].numpy(),
                                   np.asarray(je[name])[:, :, :11], **TOL)
    assert cache["pos"].tolist() == [start + 11] * 2


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _shared_prefix_prompts(cfg, n=4, shared=17, total=21, seed=0):
    """``n`` prompts sharing their first ``shared`` tokens (2 full pages
    at page size 8), diverging after."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, cfg.vocab_size, total).astype(np.int32)
               for _ in range(n)]
    for p in prompts[1:]:
        p[:shared] = prompts[0][:shared]
    return prompts


def _kw(cfg, K, max_new=8, **kw):
    return {**dict(slots=4, cache_len=64, mode="camd", n_candidates=3,
                   max_new_tokens=max_new, eos_id=cfg.vocab_size, seed=0,
                   macro_steps=K), **kw}


def _engines(jmodel, jparams, model, cfg, impl, K, kv_dtype="auto",
             page_size=8, max_new=8, **kw):
    """The reference's ``paged`` engine and the port's ``impl`` engine
    with the same settings."""
    budget = kw.pop("budget", 0)
    common = _kw(cfg, K, max_new, **kw)
    jeng = JEngine(jmodel, jparams, impl="paged",
                   paged_kv=JPaged(page_size=page_size, kv_dtype=kv_dtype,
                                   kv_byte_budget=budget),
                   sampling=JSampling(max_new_tokens=max_new,
                                      temperature=0.8),
                   camd=JCAMD(**CAMD), **common)
    eng = ServeEngine(model, impl=impl,
                      paged_kv=tconfig.PagedKVConfig(
                          page_size=page_size, kv_dtype=kv_dtype,
                          kv_byte_budget=budget),
                      sampling=tconfig.SamplingConfig(max_new_tokens=max_new,
                                                      temperature=0.8),
                      camd=tconfig.CAMDConfig(**CAMD),
                      noise=ReferenceNoise(0, legacy=K == 0), **common)
    return jeng, eng


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    with torch.inference_mode():
        return sorted(eng.run(), key=lambda r: r.uid)


def _streams(res):
    return [[c["tokens"].tolist() for c in r.candidates] for r in res]


SCHED_KEYS = ("prefill_calls", "prefill_tokens", "chunk_calls",
              "chunk_tokens", "admitted_candidates")
KV_KEYS = ("prefix_cache", "max_in_use", "in_use", "bytes_per_page",
           "budget_evictions", "kv_byte_budget")


def _outcome(eng, res):
    """What a run must reproduce: streams, rounds, p*, prefill and chunk
    counts, pool and prefix-cache stats, and the loop's telemetry."""
    s, kv = eng.sched_stats(), eng.kv_stats()
    return {"streams": _streams(res),
            "rounds": [(r.n_candidates, r.rounds) for r in res],
            "p_star": [r.p_star for r in res],
            "sched": {k: s[k] for k in SCHED_KEYS},
            "kv": {k: kv.get(k) for k in KV_KEYS},
            "loop": (eng.total_steps, eng.macro_launches, eng.host_syncs)}


def _assert_same_run(exp, eng, out):
    """``exp``: the reference's ``_outcome``; ``out``: the port's results."""
    got = _outcome(eng, out)
    np.testing.assert_allclose(got.pop("p_star"), exp["p_star"], **TOL)
    assert got == {k: v for k, v in exp.items() if k != "p_star"}
    eng.pool.check()


@pytest.fixture(scope="module")
def reference_runs():
    """The reference engine's outcomes, run once per module and setting
    (``_reference``), so that the port's impls share one reference run."""
    return {}


def _reference(runs, key, jeng, waves):
    """The reference engine's outcome after each of ``waves`` (lists of
    requests), memoised under ``key``."""
    if key not in runs:
        runs[key] = [_outcome(jeng, _run(jeng, reqs)) for reqs in waves]
    return runs[key]


@pytest.mark.parametrize("impl", ["paged", "paged_cuda"])
def test_prefix_cache_engine_equals_reference(tiny, reference_runs, impl):
    """Four prompts sharing two pages, then the same four again: the first
    wave's later requests hit the two pages the first one seeded (6 page
    hits), the second wave hits everything it can. Streams, prefill
    tokens, the cache's stats and the loop's telemetry equal the
    reference's; after the run only the cache holds pages, one hold each,
    ``reset_stats`` keeps them, and ``drop_all`` empties the pool."""
    jcfg, jmodel, jparams, model = tiny
    jeng, eng = _engines(jmodel, jparams, model, jcfg, impl, 8,
                         prefix_cache=True)
    prompts = _shared_prefix_prompts(jcfg)
    waves = [[(uid0 + i, p) for i, p in enumerate(prompts)]
             for uid0 in (0, 100)]
    exp = _reference(reference_runs, "text", jeng,
                     [[JRequest(uid=u, prompt=p) for u, p in w]
                      for w in waves])
    for wave, want in zip(waves, exp):
        out = _run(eng, [Request(uid=u, prompt=p) for u, p in wave])
        _assert_same_run(want, eng, out)
    pc = eng.kv_stats()["prefix_cache"]
    assert pc["hits"] > 6 and pc["hit_tokens"] == 8 * pc["hits"]
    cached = [n.page for n in eng.pool.prefix._nodes.values()]
    assert eng.pool.in_use == len(cached) > 0
    assert all(eng.pool.refcount(p) == 1 for p in cached)
    # reset_stats zeroes the counters and keeps the cached chains
    eng.reset_stats()
    pc = eng.kv_stats()["prefix_cache"]
    assert (pc["probes"], pc["hits"], eng.prefill_tokens,
            eng.total_steps) == (0, 0, 0, 0)
    assert pc["cached_pages"] == len(cached) == eng.kv_stats()["max_in_use"]
    eng.pool.prefix.drop_all()
    eng.pool.check()
    assert eng.pool.in_use == 0 and eng._reserved == 0


def test_moe_prefix_cache_equals_reference(granite_tight):
    """The reduced granite (4 experts, top-2) at capacity factor 1.0, where
    expert capacity binds, with the prefix cache: a hit's suffix prefill
    routes its tokens in other capacity groups than the whole prompt
    would, in both packages alike (the reference's ``xla`` semantics, R4),
    so streams, prefill tokens and the cache's stats equal the reference
    engine's with the cache on."""
    jcfg, jmodel, jparams, model = granite_tight
    jeng, eng = _engines(jmodel, jparams, model, jcfg, "paged_cuda", 8,
                         prefix_cache=True)
    prompts = _shared_prefix_prompts(jcfg)
    exp = _outcome(jeng, _run(jeng, [JRequest(uid=i, prompt=p)
                                     for i, p in enumerate(prompts)]))
    out = _run(eng, [Request(uid=i, prompt=p)
                     for i, p in enumerate(prompts)])
    _assert_same_run(exp, eng, out)
    assert eng.kv_stats()["prefix_cache"]["hits"] == 6


def _image_requests(jcfg, req_cls, n=5, pool=2, plen=13, seed=4):
    """``n`` image requests drawing from ``pool`` seeded images, with
    prompts of ``plen`` tokens, the first five shared."""
    rng = np.random.default_rng(seed)
    v = jcfg.vision
    images = [rng.standard_normal((v.image_h, v.image_w, v.channels))
              .astype(np.float32) for _ in range(pool)]
    head = rng.integers(2, jcfg.vocab_size, 5)
    reqs = []
    for i in range(n):
        prompt = rng.integers(2, jcfg.vocab_size, plen).astype(np.int32)
        prompt[:5] = head
        reqs.append(req_cls(uid=i, prompt=prompt,
                            image=images[int(rng.integers(pool))]))
    return reqs


def test_int8_image_prefix_cache_under_budget_equals_reference(llava):
    """Image requests on the reduced llava (8 image tokens, page size 4)
    from an int8 pool under a byte budget of 12 pages: repeated images hit
    their two image pages (a suffix prefill against dequantized context),
    the budget evicts cached-only pages, and a request with raw evidence
    never probes the cache. Image key streams, streams, prefill tokens,
    evictions and the cache's stats equal the reference engine's."""
    jcfg, jmodel, jparams, model = llava
    probe = ServeEngine(model, impl="paged", cache_len=64,
                        paged_kv=tconfig.PagedKVConfig(page_size=4,
                                                       kv_dtype="int8"))
    budget = 12 * probe.kv_stats()["bytes_per_page"]
    jeng, eng = _engines(jmodel, jparams, model, jcfg, "paged_cuda", 8,
                         kv_dtype="int8", page_size=4, prefix_cache=True,
                         budget=budget)
    assert eng.pool.kv_byte_budget == budget
    reqs = _image_requests(jcfg, Request)
    jreqs = _image_requests(jcfg, JRequest)
    raw = np.random.default_rng(9).standard_normal(
        (jcfg.num_evidence_tokens, jcfg.evidence_dim)).astype(np.float32)
    reqs.append(Request(uid=5, prompt=reqs[0].prompt, evidence=raw))
    jreqs.append(JRequest(uid=5, prompt=jreqs[0].prompt, evidence=raw))
    exp = _outcome(jeng, _run(jeng, jreqs))
    out = _run(eng, reqs)
    for r, jr in zip(reqs, jreqs):
        want = jeng._prefix_token_stream(jr)
        got = eng._prefix_token_stream(r)
        assert (got is None) == (want is None) == (r.uid == 5)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    _assert_same_run(exp, eng, out)
    s = eng.kv_stats()
    assert s["prefix_cache"]["hits"] >= 2 and s["budget_evictions"] > 0
    assert s["prefix_cache"]["probes"] == 5       # not the raw request
    assert s["resident_kv_bytes"] <= budget


@pytest.mark.parametrize("K", [8, 0])
def test_cache_on_equals_cache_off(tiny, K):
    """On ``paged`` the suffix prefill against cached pages changes no
    token: streams with the cache on equal those with it off, in the
    macro-step and the legacy per-token loop, and the run with the cache
    prefills fewer tokens by exactly its hit tokens."""
    jcfg, _, _, model = tiny
    prompts = _shared_prefix_prompts(jcfg, n=3)
    runs = {}
    for pc in (False, True):
        eng = ServeEngine(model, impl="paged",
                          paged_kv=tconfig.PagedKVConfig(page_size=8),
                          sampling=tconfig.SamplingConfig(max_new_tokens=8,
                                                          temperature=0.8),
                          camd=tconfig.CAMDConfig(**CAMD), prefix_cache=pc,
                          **_kw(jcfg, K))
        res = _run(eng, [Request(uid=i, prompt=p)
                         for i, p in enumerate(prompts)])
        runs[pc] = (_streams(res), eng.prefill_tokens)
        eng.pool.check()
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] == runs[False][1] - \
        eng.kv_stats()["prefix_cache"]["hit_tokens"] < runs[False][1]
