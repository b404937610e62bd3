"""The port's chunked prefill against the JAX package's.

Chunking a prompt's prefill into page-aligned pieces is a scheduling
decision: ``Model.prefill_chunked`` equals the whole-prompt prefill (logits
and K/V within 1e-4 abs + 1e-4 rel in fp32, as the reference's own test
holds it, and within the same tolerance of the reference's chunked
prefill), and an engine with ``prefill_chunk`` gives the reference
engine's streams, prefill and chunk counts under the fifo and coverage
policies, chunk sizes 16 and 64, text and image requests (the first chunk
of an image request carries the whole image span), and under CAMD with
admissions on chunk turns, where the port restages evidence rows and the
reference does not (R5). On the port alone: a
chunk-token budget paces the jobs without changing a token, and a budget
drain mid-job returns every chunk page.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import Request as JRequest
from repro_torch.serving.engine import Request
# the fixtures: the tiny and llava model pairs, one torch thread (autouse)
from test_torch_engine_camd import _one_torch_thread, tiny  # noqa: F401
from test_torch_multimodal import llava  # noqa: F401
from test_torch_prefix_cache import (_assert_same_run, _engines,
                                     _image_requests, _outcome, _run)

TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT_LENS = (50, 6, 33, 80, 12, 64)


def _prompts(cfg, lens=PROMPT_LENS, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_model_prefill_chunked_equals_whole(tiny, chunk):
    """Chunks of 4, 8 and 16 over 13 tokens: the port's chunked prefill
    equals its whole prefill and the reference's chunked prefill within
    1e-4 (logits, hidden state, the seeded K/V and ``pos``)."""
    jcfg, jmodel, jparams, model = tiny
    rng = np.random.default_rng(0)
    toks = rng.integers(2, jcfg.vocab_size, (2, 13)).astype(np.int32)
    jlg, jh, jc = jmodel.prefill_chunked(jparams, jnp.asarray(toks),
                                         jmodel.make_cache(2, 32), chunk)
    with torch.inference_mode():
        t = torch.as_tensor(toks, dtype=torch.long)
        lg, h, c = model.prefill_chunked(t, model.make_cache(2, 32), chunk)
        wlg, wh, wc = model.prefill(t, model.make_cache(2, 32))
    for got, want in ((lg, wlg), (h, wh), (c["k"], wc["k"]),
                      (c["v"], wc["v"])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    (je,) = jc["super"]
    np.testing.assert_allclose(c["k"].numpy(), np.asarray(je["k"]), **TOL)
    assert c["pos"].tolist() == [13, 13]
    assert torch.equal(lg.argmax(-1), wlg.argmax(-1))


@pytest.mark.parametrize("chunk,policy,mode,extra", [
    (16, "fifo", "greedy", {}),
    (64, "fifo", "camd", {}),
    (16, "coverage", "camd", dict(prefill_chunk_budget=8, prefix_cache=True)),
    (64, "coverage", "greedy", {}),
])
def test_chunked_engine_equals_reference(tiny, chunk, policy, mode, extra):
    """Six prompts of 6-80 tokens at page size 8 with chunked prefill,
    through ``paged`` and ``paged_cuda`` (the kernels' plain versions on
    the CPU): the reference engine's streams, rounds, prefill and chunk
    counts, admissions and launch telemetry; every chunk page returned."""
    jcfg, jmodel, jparams, model = tiny
    kw = dict(max_new=6, cache_len=128, sched_policy=policy,
              prefill_chunk=chunk, mode=mode, **extra)
    jeng, _ = _engines(jmodel, jparams, model, jcfg, "paged", 2, **kw)
    exp = _outcome(jeng, _run(jeng, [JRequest(uid=i, prompt=p) for i, p in
                                     enumerate(_prompts(jcfg))]))
    for impl in ("paged", "paged_cuda"):
        _, eng = _engines(jmodel, jparams, model, jcfg, impl, 2, **kw)
        out = _run(eng, [Request(uid=i, prompt=p)
                         for i, p in enumerate(_prompts(jcfg))])
        _assert_same_run(exp, eng, out)
        assert eng.sched_stats()["chunk_calls"] > 0 and eng.chunk == chunk
        assert eng.chunk_budget == extra.get("prefill_chunk_budget", chunk)
        assert not eng._chunking
        cached = len(eng.pool.prefix._nodes) if eng.pool.prefix else 0
        assert eng.pool.in_use == cached and eng._reserved == 0


def test_chunk_budget_paces_without_changing_streams(tiny):
    """A budget below the chunk size spreads each job over more turns
    (chunks of 16, at most 8 chunk tokens between two launches) without
    changing a token of the unchunked engine's greedy streams."""
    jcfg, jmodel, jparams, model = tiny
    streams = {}
    for kw in ({}, dict(prefill_chunk=16, prefill_chunk_budget=8)):
        _, eng = _engines(jmodel, jparams, model, jcfg, "paged", 2,
                          max_new=6, cache_len=128, mode="greedy", **kw)
        res = _run(eng, [Request(uid=i, prompt=p)
                         for i, p in enumerate(_prompts(jcfg))])
        streams[bool(kw)] = [r.tokens.tolist() for r in res]
        eng.pool.check()
        assert eng.pool.in_use == 0
    assert streams[True] == streams[False]
    assert eng.chunk_budget == 8 and eng.sched_stats()["chunk_calls"] > 0


def test_chunked_image_prefill_equals_reference(llava):
    """Image requests on the reduced llava (8 image tokens, 21-token
    prompts) with chunks of 12 at page size 4: the first chunk of each
    job carries the image span and 4 prompt tokens, the next 12 tokens
    and the final 5 go through the suffix path. The reference engine's
    streams and counts."""
    jcfg, jmodel, jparams, model = llava
    jeng, eng = _engines(jmodel, jparams, model, jcfg, "paged_cuda", 4,
                         page_size=4, prefill_chunk=12, mode="greedy")
    exp = _outcome(jeng, _run(jeng, _image_requests(jcfg, JRequest,
                                                    plen=21)))
    out = _run(eng, _image_requests(jcfg, Request, plen=21))
    _assert_same_run(exp, eng, out)
    ne = jcfg.num_evidence_tokens
    assert eng.chunk == 12 > ne
    # 29 positions a request: chunks of 12 and 12, then a final 5
    assert eng.sched_stats()["chunk_calls"] == 3 * 5
    assert eng.pool.in_use == 0


def test_chunk_turn_admission_stages_evidence(llava):
    """CAMD on image requests with two-step launches and 12 new tokens, so
    that launches end with no completion while chunk jobs run: the second
    request's job completes on such a turn and the request is admitted
    there. The port stages the admitted slots' evidence rows before the
    next launch. The reference schedules on that turn without restaging
    them (``repro/serving/engine.py:2442-2447``, R5 in ROADMAP), so its
    candidates score S_align against the stale rows until the next
    completion. The port's run equals the reference's with the rows
    restaged after every admission pass (p* within 1e-5), and that run's
    p* differs from the unpatched reference's by more, so the turn is
    exercised."""
    jcfg, jmodel, jparams, model = llava
    kw = dict(page_size=4, prefill_chunk=12, max_new=12)
    runs = []
    for restage in (False, True):
        jeng, _ = _engines(jmodel, jparams, model, jcfg, "paged", 2, **kw)
        if restage:
            def schedule(jeng=jeng, schedule=jeng._schedule):
                schedule()
                jeng._evid = jeng._gather_evid()
            jeng._schedule = schedule
        runs.append(_outcome(jeng, _run(jeng, _image_requests(
            jcfg, JRequest, n=4, plen=21))))
    stale, exp = runs
    assert np.abs(np.subtract(stale["p_star"], exp["p_star"])).max() > 1e-5
    for impl in ("paged", "paged_cuda"):
        _, eng = _engines(jmodel, jparams, model, jcfg, impl, 2, **kw)
        out = _run(eng, _image_requests(jcfg, Request, n=4, plen=21))
        _assert_same_run(exp, eng, out)
        np.testing.assert_allclose([r.p_star for r in out], exp["p_star"],
                                   rtol=0, atol=1e-5)
        assert eng.sched_stats()["chunk_calls"] == 3 * 4
        assert eng.pool.in_use == 0


def test_finalize_starved_returns_chunk_pages(tiny):
    """A budget drain with a job mid-chunking frees its chunk pages and
    finalizes the request as starved."""
    jcfg, jmodel, jparams, model = tiny
    _, eng = _engines(jmodel, jparams, model, jcfg, "paged", 2, max_new=6,
                      cache_len=128, mode="greedy", prefill_chunk=16)
    req = Request(uid=7, prompt=_prompts(jcfg, lens=(96,), seed=4)[0])
    eng.submit(req)
    with torch.inference_mode():
        eng._start_chunk_job(req)
        assert eng._run_chunk(7, eng._chunking[7]) == 16
    held = list(eng._chunking[7]["pages"])
    assert len(held) == 2 and eng.pool.in_use == 2
    eng._finalize_starved()
    assert not eng._chunking and eng.starved_uids == [7]
    assert len(eng.result(7).tokens) == 0
    eng.pool.check()
    assert eng.pool.in_use == 0
    assert all(eng.pool.refcount(p) == 0 for p in held)
