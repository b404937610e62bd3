"""The port's async front-end against the JAX package's.

Routing requests through ``AsyncServeFrontend`` changes when tokens are
delivered, never which: greedy streams equal a synchronous ``run()`` of
the same prompts, and CAMD results (which stream at completion) equal the
JAX front-end's. Both packages' front-ends are driven by their own
``drive_open_loop`` with every arrival at t = 0 (no timer, so the event
loop's order, and with it the pump at which each cancel lands, is the
same in both) and the same cancel-after-one-token plan; the streams
delivered, the cancelled flags, the results and the engines' counters
must be equal. Also: a request submitted mid-stream of another, the
macro-step loop required, submit before start refused, and a pump failure
raised on every waiter and by ``close``.
"""
import asyncio

import numpy as np
import pytest
import torch

from repro.serving import AsyncServeFrontend as JFrontend
from repro.serving import Request as JRequest
from repro.serving import traffic as jtraffic
from repro_torch.serving import AsyncServeFrontend, Request
from repro_torch.serving import traffic
# the engine pairs; the fixtures: the tiny model pair, one torch thread
from test_torch_cancellation import _engines
from test_torch_engine_camd import _one_torch_thread, tiny  # noqa: F401

MAX_NEW = 8
N_REQ = 6
TOL = dict(rtol=1e-4, atol=1e-4)


def _prompts(cfg, n=N_REQ, seed=0, plen=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size, plen).astype(np.int32)
            for _ in range(n)]


def _greedy(pair):
    return _engines(pair, max_new=MAX_NEW)


def _drive(fe_cls, drive, eng, reqs, cancel_uids=()):
    """``drive_open_loop`` over a started front-end, every arrival at 0;
    also each request's delivered stream (collected by wrapping
    ``stream``)."""
    delivered = {r.uid: [] for r in reqs}

    async def main():
        async with fe_cls(eng) as fe:
            inner = fe.stream

            async def stream(uid):
                async for t in inner(uid):
                    delivered[uid].append(int(t))
                    yield t
            fe.stream = stream
            return await drive(fe, reqs, np.zeros(len(reqs)),
                               cancel_uids=cancel_uids,
                               cancel_after_tokens=1)

    with torch.inference_mode():
        traces = asyncio.run(main())
    return traces, delivered


@pytest.fixture(scope="module")
def golden(tiny):
    """The port's synchronous greedy streams, by prompt index."""
    jcfg = tiny[0]
    _, eng = _greedy(tiny)
    prompts = _prompts(jcfg)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p))
    with torch.inference_mode():
        res = eng.run()
    return prompts, {r.uid: [int(t) for t in r.tokens] for r in res}


def test_greedy_streams_and_cancels_equal_reference(tiny, golden):
    """Six greedy requests through both front-ends, requests 0 and 3
    cancelled after their first streamed token: delivered streams and
    flags equal the reference's, the survivors' streams equal ``run()``'s,
    a cancelled stream is a prefix of it, every token arrives in
    per-launch deltas with no extra host sync, and nothing leaks."""
    prompts, ref = golden
    jeng, eng = _greedy(tiny)
    cancel = (0, 3)
    out = {}
    for name, e, fe_cls, drive, req_cls in (
            ("jax", jeng, JFrontend, jtraffic.drive_open_loop, JRequest),
            ("port", eng, AsyncServeFrontend, traffic.drive_open_loop,
             Request)):
        reqs = [req_cls(uid=i, prompt=p) for i, p in enumerate(prompts)]
        traces, delivered = _drive(fe_cls, drive, e, reqs, cancel)
        out[name] = ([(t.uid, t.n_tokens, t.cancelled) for t in traces],
                     delivered,
                     (e.total_steps, e.macro_launches, e.host_syncs),
                     e.cancelled_requests, dict(e.sched_stats()))
    assert out["port"] == out["jax"]
    traces, delivered = out["port"][:2]
    for uid, n_tokens, cancelled in traces:
        assert cancelled == (uid in cancel)
        if cancelled:
            assert 0 < len(delivered[uid]) < MAX_NEW
            assert delivered[uid] == ref[uid][:len(delivered[uid])]
        else:
            assert delivered[uid] == ref[uid] and n_tokens == MAX_NEW
    assert eng.macro_launches > 1 and eng.stream_tokens is False
    eng.pool.check()
    assert eng.pool.in_use == 0 and eng.scheduler.committed == 0
    assert all(int(eng._slot_req[s]) == -1 for s in range(eng.B))
    assert eng.cancelled_requests == len(cancel)


def test_camd_results_equal_reference(tiny):
    """CAMD streams deliver the chosen candidate at completion: through
    both front-ends the results are equal (tokens, candidates, rounds,
    p* and scores within 1e-4), and the delivered streams are the results'
    tokens."""
    jcfg = tiny[0]
    kw = dict(mode="camd", slots=4, max_new=4, eos_id=1, n_candidates=3)
    prompts = _prompts(jcfg, n=4, seed=3)
    got = {}
    for name, fe_cls, drive, req_cls, e in (
            ("jax", JFrontend, jtraffic.drive_open_loop, JRequest,
             _engines(tiny, **kw)[0]),
            ("port", AsyncServeFrontend, traffic.drive_open_loop, Request,
             _engines(tiny, **kw)[1])):
        reqs = [req_cls(uid=i, prompt=p) for i, p in enumerate(prompts)]
        traces, delivered = _drive(fe_cls, drive, e, reqs)
        res = [e.result(i) for i in range(len(prompts))]
        for r in res:
            assert delivered[r.uid] == [int(t) for t in r.tokens]
        got[name] = ([([int(t) for t in r.tokens], r.n_candidates,
                       r.tokens_spent, r.rounds, r.cancelled) for r in res],
                     [r.p_star for r in res],
                     [c["score"] for r in res for c in r.candidates],
                     (e.total_steps, e.macro_launches, e.host_syncs))
    (exp, jp, js, jloop), (out, tp, ts, loop) = got["jax"], got["port"]
    assert out == exp and loop == jloop
    np.testing.assert_allclose(tp, jp, **TOL)
    np.testing.assert_allclose(ts, js, **TOL)


def test_submit_while_running(tiny, golden):
    """A request submitted mid-stream of another is admitted between macro
    launches and still gives the golden stream."""
    prompts, ref = golden
    _, eng = _greedy(tiny)

    async def main():
        async with AsyncServeFrontend(eng) as fe:
            await fe.submit(Request(uid=0, prompt=prompts[0]))
            first = []
            async for t in fe.stream(0):
                first.append(int(t))
                if len(first) == 2:       # mid-stream: inject request 1
                    await fe.submit(Request(uid=1, prompt=prompts[1]))
            second = [int(t) async for t in fe.stream(1)]
            return first, second, await fe.result(0), await fe.result(1)

    with torch.inference_mode():
        first, second, res0, res1 = asyncio.run(main())
    assert first == ref[0] and second == ref[1]
    assert not res0.cancelled and not res1.cancelled
    # the engine runs synchronously again after the front-end closed
    eng.submit(Request(uid=2, prompt=prompts[2]))
    with torch.inference_mode():
        res = {r.uid: r for r in eng.run()}
    assert [int(t) for t in res[2].tokens] == ref[2]
    assert eng.drain_stream_events() == []


def test_frontend_requires_macro_loop(tiny):
    _, eng = _engines(tiny, macro_steps=0)
    with pytest.raises(ValueError, match="macro"):
        AsyncServeFrontend(eng)
    with pytest.raises(RuntimeError, match="macro"):
        eng.pump()


def test_submit_before_start_raises(tiny):
    _, eng = _greedy(tiny)
    fe = AsyncServeFrontend(eng)

    async def main():
        with pytest.raises(RuntimeError, match="not started"):
            await fe.submit(Request(uid=0, prompt=np.arange(
                2, 8, dtype=np.int32)))
    asyncio.run(main())


def test_pump_failure_reaches_every_waiter(tiny, golden):
    """A failure inside ``pump`` (standing in for a device fault) is set on
    every waiting result, ends every stream, refuses later submits and is
    raised again when the front-end closes."""
    prompts = golden[0]
    _, eng = _greedy(tiny)

    def broken():
        raise RuntimeError("device fault")
    eng.pump = broken

    async def main():
        fe = await AsyncServeFrontend(eng).start()
        for i in range(2):
            await fe.submit(Request(uid=i, prompt=prompts[i]))
        streams = [[t async for t in fe.stream(i)] for i in range(2)]
        for i in range(2):
            with pytest.raises(RuntimeError, match="device fault"):
                await fe.result(i)
        with pytest.raises(RuntimeError, match="pump failed"):
            await fe.submit(Request(uid=5, prompt=prompts[2]))
        with pytest.raises(RuntimeError, match="device fault"):
            await fe.close()
        return streams

    assert asyncio.run(main()) == [[], []]
