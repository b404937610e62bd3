"""The port's cancellation and token streaming against the JAX package's.

``ServeEngine.cancel`` drops queued work at once and tears running
candidates down at the next step boundary: staged frontier pages return
wholesale, held pages and the slot free, and the scheduler refunds the
candidate's worst-case commitment. Each timing class of the reference's
own suite (``tests/test_cancellation.py``: unknown, finished, queued,
running, mid chunked prefill) and a few fixed mixed plans run as
pump-boundary cancel plans on a greedy paged engine (3 slots, K 2, page
size 8, eos outside the vocabulary) in both packages, with
``stream_tokens`` on. The port must give the reference's results
(tokens, ``cancelled``, ``tokens_spent``), ``cancelled_requests``,
``sched_stats()``, frontier counters, (steps, launches, host syncs) and
stream events; each finished candidate's deltas concatenate to its
tokens. One CAMD case on the reduced llava cancels a request mid-round
(p* and scores within 1e-4 + 1e-4 rel), one speculating engine (spec_k 4)
cancels running slots, and a hypothesis property on the port alone fires
cancels at random pump boundaries and checks that no page, slot or
budget token leaks.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.config import CAMDConfig as JCAMD
from repro.config import PagedKVConfig as JPaged
from repro.config import SamplingConfig as JSampling
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JEngine
from repro_torch import config as tconfig
from repro_torch.serving.engine import Request, ServeEngine
# the reference engine's Gumbel draws; the fixtures: the tiny and llava
# model pairs, one torch thread (autouse)
from test_torch_engine_camd import (ReferenceNoise,  # noqa: F401
                                    _one_torch_thread, tiny)
from test_torch_multimodal import llava  # noqa: F401

MAX_NEW = 6
TOL = dict(rtol=1e-4, atol=1e-4)
CAMD = dict(samples_per_round=2, max_rounds=2, min_samples=2,
            max_clusters=8)
KV_KEYS = ("frontier_staged", "frontier_returned", "frontier_peak_stage",
           "in_use", "max_in_use")


def _common(cfg, **kw):
    return {**dict(mode="greedy", macro_steps=2, slots=3, cache_len=64,
                   max_new_tokens=MAX_NEW, eos_id=cfg.vocab_size, seed=0),
            **kw}


def _engines(pair, max_new=MAX_NEW, page_size=8, temperature=0.8, **kw):
    """The reference's ``paged`` engine and the port's with the same
    settings (the conftest's ``_mk_engine`` defaults), both streaming."""
    jcfg, jmodel, jparams, model = pair
    common = _common(jcfg, max_new_tokens=max_new, **kw)
    camd = common.pop("camd", CAMD)
    jeng = JEngine(jmodel, jparams, impl="paged",
                   paged_kv=JPaged(page_size=page_size),
                   sampling=JSampling(max_new_tokens=max_new,
                                      temperature=temperature),
                   camd=JCAMD(**camd), **common)
    eng = ServeEngine(model, impl="paged",
                      paged_kv=tconfig.PagedKVConfig(page_size=page_size),
                      sampling=tconfig.SamplingConfig(
                          max_new_tokens=max_new, temperature=temperature),
                      camd=tconfig.CAMDConfig(**camd),
                      noise=ReferenceNoise(0), **common)
    jeng.stream_tokens = eng.stream_tokens = True
    return jeng, eng


def _requests(cfg, req_cls, lens, uid0=0):
    """One request a prompt length, uids from ``uid0``, the prompt of uid
    u from ``default_rng(u)`` as the reference suite draws them."""
    out = []
    for i, n in enumerate(lens):
        rng = np.random.default_rng(uid0 + i)
        out.append(req_cls(uid=uid0 + i, prompt=rng.integers(
            2, cfg.vocab_size, n).astype(np.int32)))
    return out


def _drain(eng, cancels, events):
    """Pump to completion, firing ``cancels[i]`` (uids) after pump i and
    draining the stream feed after every pump. Returns the pumps run."""
    i = 0
    with torch.inference_mode():
        while True:
            more = eng.pump()
            events += eng.drain_stream_events()
            for uid in cancels.get(i, ()):
                eng.cancel(uid)
            i += 1
            if not more:
                return i


def _outcome(eng, uids, events):
    """What the port must reproduce, exactly."""
    res = [eng.result(u) for u in uids]
    kv = eng.kv_stats()
    return {"results": [(r.uid, [int(t) for t in r.tokens], r.cancelled,
                         r.tokens_spent, r.n_candidates, r.rounds)
                        for r in res],
            "candidates": [[(c["uid"], c["tokens"].tolist())
                            for c in r.candidates] for r in res],
            "cancelled_requests": eng.cancelled_requests,
            "sched": dict(eng.sched_stats()),
            "kv": {k: kv[k] for k in KV_KEYS},
            "loop": (eng.total_steps, eng.macro_launches, eng.host_syncs),
            "events": [(int(u), int(c), [int(t) for t in toks])
                       for u, c, toks in events]}


def _assert_deltas_complete(out):
    """Every finished candidate's stream deltas concatenate to its
    tokens."""
    streamed = {}
    for _, cand, toks in out["events"]:
        streamed.setdefault(cand, []).extend(toks)
    for cands in out["candidates"]:
        for cand, toks in cands:
            assert streamed.get(cand) == toks, cand


def _assert_conserved(eng):
    """Nothing outlives a drained engine: every page back on the free list
    (prefix-cache residents aside), every slot idle and pointed at the
    quarantine page (a torn-down slot keeps decoding masked rows, whose
    writes must not land in pages the pool hands on), the scheduler's
    commitment refunded, every slot's verify width reset."""
    eng.pool.check()
    resident = len(eng.pool.prefix._nodes) if eng.pool.prefix else 0
    assert eng.pool.in_use == resident
    assert all(int(eng._slot_req[s]) == -1 for s in range(eng.B))
    assert not bool(eng.state.active.any())
    assert bool((eng.state.cache["block_table"] ==
                 eng.pool.quarantine_page()).all())
    assert eng.scheduler.committed == 0 and eng._reserved == 0
    assert (eng._slot_spec == 1).all() and (eng._slot_streamed == 0).all()


def _both(jeng, eng, cfg, lens, cancels, pre=(), run=False, uid0=0):
    """The same plan through both engines, their counters reset first:
    requests ``uid0 + i``, the ``pre`` indices cancelled before any pump,
    then ``run()`` or a pump drain cancelling ``cancels[p]`` (indices)
    after pump p. Returns (reference outcome, port outcome, the
    pre-cancels' return values)."""
    uids = [uid0 + i for i in range(len(lens))]
    at = {p: [uid0 + i for i in idx] for p, idx in cancels.items()}
    outs, rets = [], []
    for e, req_cls in ((jeng, JRequest), (eng, Request)):
        e.reset_stats()
        events = []
        for r in _requests(cfg, req_cls, lens, uid0):
            e.submit(r)
        rets.append([e.cancel(uid0 + i) for i in pre])
        if run:
            with torch.inference_mode():
                e.run()
            events += e.drain_stream_events()
        else:
            _drain(e, at, events)
        outs.append(_outcome(e, uids, events))
    return outs[0], outs[1], rets


# ---------------------------------------------------------------------------
# timing classes and fixed plans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def greedy_pair(tiny):
    """One engine pair for the module's greedy plans (each test takes its
    own uids and resets the counters), as the reference suite shares its
    engine: the JAX engine compiles once."""
    return tiny[0], _engines(tiny)


def test_cancel_unknown_and_finished(greedy_pair):
    jcfg, (jeng, eng) = greedy_pair
    outs = []
    for e, req_cls in ((jeng, JRequest), (eng, Request)):
        e.reset_stats()
        e.pop_finished()
        assert e.cancel(10**9) is False            # never submitted
        e.submit(_requests(jcfg, req_cls, (6,), 900)[0])
        with torch.inference_mode():
            e.run()
        assert e.cancel(900) is False              # already finished
        assert not e.result(900).cancelled
        assert e.pop_finished() == [900] and e.pop_finished() == []
        outs.append(_outcome(e, [900], e.drain_stream_events()))
    assert outs[1] == outs[0]
    _assert_deltas_complete(outs[1])
    _assert_conserved(eng)


@pytest.mark.parametrize("uid0,lens,pre,cancels,run", [
    # queued and never prefilled: dropped at once (and only once)
    (0, (6, 6, 6), (1, 1), {}, True),
    # running, at the first pump boundary: the staged frontier returns
    (10, (6, 6, 6), (), {0: [0]}, False),
    # running, queued and finished targets over six requests
    (20, (6,) * 6, (), {0: [0], 1: [3], 2: [5]}, False),
    (30, (6, 9, 6, 14, 6, 6), (), {0: [2, 4], 3: [1]}, False),
    (40, (6, 9, 20, 6, 6, 12), (4,), {1: [0, 1], 2: [2], 9: [5]}, False),
], ids=["queued", "running", "mixed_a", "mixed_b", "mixed_c"])
def test_cancel_plan_equals_reference(greedy_pair, uid0, lens, pre,
                                      cancels, run):
    jcfg, (jeng, eng) = greedy_pair
    exp, got, rets = _both(jeng, eng, jcfg, lens, cancels, pre, run, uid0)
    assert rets[1] == rets[0]
    assert got == exp
    assert got["cancelled_requests"] > 0
    assert any(c for _, _, c, *_ in got["results"])
    for uid, toks, cancelled, *_ in got["results"]:
        assert cancelled or len(toks) == MAX_NEW   # eos outside the vocab
    _assert_deltas_complete(got)
    _assert_conserved(eng)


def test_streaming_adds_no_host_sync(port_engine):
    """The same cancel plan with ``stream_tokens`` off and on: the same
    results, steps, launches and host syncs (the deltas ride each
    launch's one sync)."""
    cfg, eng = port_engine
    runs = []
    for stream, uid0 in ((False, 60), (True, 70)):
        eng.stream_tokens = stream
        eng.reset_stats()
        for r in _requests(cfg, Request, (6, 9, 6, 12, 6), uid0):
            eng.submit(r)
        events = []
        _drain(eng, {0: [uid0 + 1], 2: [uid0 + 3]}, events)
        assert bool(events) == stream
        runs.append(([(len(eng.result(uid0 + i).tokens),
                       eng.result(uid0 + i).cancelled) for i in range(5)],
                     eng.total_steps, eng.macro_launches, eng.host_syncs))
    eng.stream_tokens = True
    assert runs[1] == runs[0]
    assert sum(c for _, c in runs[1][0]) == 2
    _assert_conserved(eng)


def test_cancel_mid_chunk_returns_chunk_pages(tiny):
    """The cancel lands while the long prompt is mid chunked prefill: its
    job holds pages, it has no slot and no request record yet. The job
    teardown frees every chunk page, in both packages alike."""
    jcfg = tiny[0]
    jeng, eng = _engines(tiny, cache_len=128, prefill_chunk=16,
                         prefill_chunk_budget=16)
    outs = []
    for e, req_cls in ((jeng, JRequest), (eng, Request)):
        reqs = _requests(jcfg, req_cls, (6, 6, 96))
        events = []
        e.submit(reqs[0])
        e.submit(reqs[1])
        with torch.inference_mode():
            e.pump()                               # shorts admitted, live
            e.submit(reqs[2])
            e.pump()                               # job opens, one chunk
        assert 2 in e._chunking
        held = list(e._chunking[2]["pages"])
        assert held
        assert e.cancel(2)
        events += e.drain_stream_events()
        _drain(e, {}, events)
        assert all(e.pool.refcount(p) == 0 for p in held)
        outs.append(_outcome(e, range(3), events))
    assert outs[1] == outs[0]
    assert outs[1]["results"][2][2] is True
    assert outs[1]["sched"]["chunk_calls"] > 0
    _assert_deltas_complete(outs[1])
    _assert_conserved(eng)


def test_camd_cancel_mid_round_equals_reference(llava):
    """CAMD on the reduced llava with image requests (4 slots, 2 samples a
    round): request 0 is cancelled while its round decodes, which frees
    its slots for the queued request 3, admitted with the evidence rows
    restaged. Streams, rounds and flags equal the reference's; p* and
    every candidate's score within 1e-4 + 1e-4 rel."""
    jcfg = llava[0]
    jeng, eng = _engines(llava, max_new=8, mode="camd", slots=4,
                         n_candidates=3, cache_len=64, eos_id=1,
                         camd=dict(CAMD, max_rounds=3))
    rng = np.random.default_rng(5)
    v = jcfg.vision
    images = rng.standard_normal((2, v.image_h, v.image_w, v.channels)) \
        .astype(np.float32)
    prompts = [rng.integers(2, jcfg.vocab_size, n).astype(np.int32)
               for n in (6, 9, 7, 5)]
    outs = []
    for e, req_cls in ((jeng, JRequest), (eng, Request)):
        for i, p in enumerate(prompts):
            e.submit(req_cls(uid=i, prompt=p, image=images[i % 2]))
        events = []
        _drain(e, {1: [0]}, events)
        res = [e.result(u) for u in range(4)]
        outs.append((_outcome(e, range(4), events),
                     [r.p_star for r in res],
                     [c["score"] for r in res for c in r.candidates]))
    (exp, jp, js), (got, tp, ts) = outs
    np.testing.assert_allclose(tp, jp, **TOL)
    np.testing.assert_allclose(ts, js, **TOL)
    assert got == exp
    assert got["results"][0][2] is True and got["cancelled_requests"] == 1
    assert got["sched"]["cancelled_candidates"] == 2
    _assert_deltas_complete(got)
    _assert_conserved(eng)


def test_speculative_cancel_equals_reference(tiny):
    """A speculating greedy engine (spec_k 4, K 2): cancelled running
    slots have their verify width reset, and the run equals the
    reference's, drafts included."""
    jcfg = tiny[0]
    jeng, eng = _engines(tiny, max_new=10, spec_k=4)
    exp, got, _ = _both(jeng, eng, jcfg, (6, 9, 6, 12, 6),
                        {0: [0], 1: [3]})
    assert got == exp
    assert (eng.spec_drafted, eng.spec_accepted) == \
        (jeng.spec_drafted, jeng.spec_accepted)
    assert got["cancelled_requests"] == 2
    _assert_deltas_complete(got)
    _assert_conserved(eng)


def test_reset_stats_zeroes_cancel_counters(port_engine):
    """``reset_stats`` zeroes ``cancelled_requests`` with the other
    counters; the budget ledgers stay."""
    cfg, eng = port_engine
    eng.reset_stats()
    for r in _requests(cfg, Request, (6, 6), 50):
        eng.submit(r)
    _drain(eng, {0: [50]}, [])
    assert eng.cancelled_requests == 1
    spent = eng.scheduler.spent
    eng.reset_stats()
    s = eng.sched_stats()
    assert eng.cancelled_requests == s["cancelled_requests"] == 0
    assert s["cancelled_candidates"] == 0
    assert eng.scheduler.spent == spent
    _assert_conserved(eng)


# ---------------------------------------------------------------------------
# property: random cancel timing conserves pages, slots and budget
# ---------------------------------------------------------------------------

_UIDS = itertools.count(100)


@pytest.fixture(scope="module")
def port_engine(tiny):
    return tiny[0], _engines(tiny)[1]


def _check_conservation(port_engine, plan):
    """Whatever subset of 6 requests is cancelled at whatever pump
    boundary (requests outnumber slots, so plans hit queued, running and
    finished targets), the drained engine holds no page, no busy slot and
    no commitment, and every request resolves."""
    cfg, eng = port_engine
    uids = [next(_UIDS) for _ in range(6)]
    cancels = {}
    for idx, at in plan:
        cancels.setdefault(at, []).append(uids[idx])
    for uid in uids:
        rng = np.random.default_rng(uid)
        eng.submit(Request(uid=uid, prompt=rng.integers(
            2, cfg.vocab_size, 6).astype(np.int32)))
    _drain(eng, cancels, [])
    planned = {uids[idx] for idx, _ in plan}
    for uid in uids:
        r = eng.result(uid)
        assert uid in planned if r.cancelled else len(r.tokens) == MAX_NEW
    _assert_conserved(eng)


try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # without hypothesis: fixed plans
    st = None

if st is not None:
    @settings(max_examples=6, deadline=None)
    @given(plan=st.lists(st.tuples(st.integers(0, 5), st.integers(0, 3)),
                         min_size=0, max_size=4,
                         unique_by=lambda t: t[0]))
    def test_conservation_under_random_cancel_timing(port_engine, plan):
        _check_conservation(port_engine, plan)
else:
    @pytest.mark.parametrize("plan", [
        [], [(0, 0)], [(0, 0), (3, 1), (5, 2)], [(1, 3), (2, 0), (4, 0)]])
    def test_conservation_under_random_cancel_timing(port_engine, plan):
        _check_conservation(port_engine, plan)
