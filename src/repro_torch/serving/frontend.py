"""Async streaming front-end for ``ServeEngine``.

The port of ``repro/serving/frontend.py``. Request stream in, token
stream out: ``submit`` enqueues a request into the engine between macro
launches, ``stream`` yields its tokens as the engine emits them,
``cancel`` aborts it mid-stream (pages returned, slot freed, scheduler
commitment refunded: ``ServeEngine.cancel``), and ``result`` resolves to
the request's final ``Result``.

One cooperative asyncio task (``_pump_loop``) owns the engine. Each turn
runs exactly one ``ServeEngine.pump()``, one macro launch (a graph replay
on the card) and its host-side fold, then drains the engine's
stream-event and completion feeds into per-request ``asyncio.Queue``s and
yields the event loop, so client coroutines (arrival timers, stream
consumers, cancellers) run between launches. The engine is driven from
one thread, which also makes cancellation race-free: a ``cancel`` always
lands at a step boundary, where the engine applies it.

Token streams are incremental (per-launch deltas riding the launch's one
host sync) when the engine decodes one greedy candidate a request; the
other modes choose their answer at completion, so their streams deliver
the chosen candidate's tokens when the request finishes. Either way the
stream's concatenation equals the synchronous ``run()`` result.

A failure in the pump (a device fault included) is set on every waiter's
result, ends every stream, and is raised again by ``close``.
"""
from __future__ import annotations

import asyncio
from typing import Dict, Optional, Set

import numpy as np
import torch

from repro_torch.serving.engine import Request, Result, ServeEngine

_DONE = object()          # stream-termination sentinel


class AsyncServeFrontend:
    """Asyncio front-end over one ``ServeEngine`` (macro-step loop).

    Usage::

        async with AsyncServeFrontend(engine) as fe:
            await fe.submit(Request(uid=0, prompt=...))
            async for tok in fe.stream(0):
                ...
            res = await fe.result(0)
    """

    def __init__(self, engine: ServeEngine):
        if engine.macro_steps <= 0:
            raise ValueError(
                "AsyncServeFrontend drives the fused macro-step loop; "
                "construct the engine with macro_steps >= 1")
        world = engine.world
        if world is not None and world.size > 1:
            # every rank must see the same arrivals at the same launches
            raise NotImplementedError(
                f"the async front-end over {world.size} ranks is not "
                "ported yet (ROADMAP.md Queue 1 item 5, step 7, the "
                "front-end over ranks)")
        self.engine = engine
        # per-launch deltas only where the one candidate is the answer;
        # the other modes pick at completion
        self._incremental = \
            engine.mode == "greedy" and engine.n_candidates == 1
        engine.stream_tokens = self._incremental
        self._queues: Dict[int, asyncio.Queue] = {}
        self._futs: Dict[int, asyncio.Future] = {}
        self._closed: Set[int] = set()
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._error: Optional[BaseException] = None

    # -- lifecycle ------------------------------------------------------
    async def start(self) -> "AsyncServeFrontend":
        if self._task is None:
            self._wake = asyncio.Event()
            self._task = asyncio.create_task(self._pump_loop())
        return self

    async def close(self) -> None:
        """Stop the pump and leave the engine reusable for ``run()``;
        raises the pump's failure, if it had one."""
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        # nothing drains the stream feed once the front-end is gone
        self.engine.stream_tokens = False
        self.engine.stream_events.clear()
        if self._error is not None:
            raise self._error

    async def __aenter__(self) -> "AsyncServeFrontend":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- client API -----------------------------------------------------
    async def submit(self, req: Request) -> int:
        """Enqueue a request; it is admitted at a later pump."""
        self._require_ok()
        self.engine.submit(req)
        self._queues[req.uid] = asyncio.Queue()
        self._futs[req.uid] = asyncio.get_running_loop().create_future()
        self._wake.set()
        return req.uid

    async def stream(self, uid: int):
        """Async iterator of the request's output tokens (ints). Ends when
        the request completes or is cancelled; tokens already emitted are
        always delivered."""
        q = self._queues[uid]
        while True:
            tok = await q.get()
            if tok is _DONE:
                return
            yield tok

    async def result(self, uid: int) -> Result:
        """The request's final ``Result`` (``cancelled=True`` if it was
        aborted)."""
        return await self._futs[uid]

    async def cancel(self, uid: int) -> bool:
        """Abort ``uid``: its stream closes at once (queued tokens stay
        deliverable) and its engine state is torn down at the next step
        boundary."""
        ok = self.engine.cancel(uid)
        self._close_stream(uid)
        if self._wake is not None:
            self._wake.set()       # the deferred teardown needs a pump
        return ok

    async def join(self) -> None:
        """Wait until every submitted request has a result."""
        if self._futs:
            await asyncio.gather(*self._futs.values())

    # -- pump -----------------------------------------------------------
    async def _pump_loop(self) -> None:
        try:
            while True:
                if self.engine.has_work():
                    with torch.inference_mode():
                        self.engine.pump()
                    self._dispatch()
                    # one event-loop turn between launches: arrivals,
                    # stream consumers and cancels run here
                    await asyncio.sleep(0)
                else:
                    self._dispatch()   # flush direct-cancel completions
                    self._wake.clear()
                    if self.engine.has_work():
                        continue       # raced with a submit
                    await self._wake.wait()
        except Exception as e:         # surfaced on every waiter
            self._error = e
            self._fail_all(e)

    def _dispatch(self) -> None:
        eng = self.engine
        for uid, _cand, toks in eng.drain_stream_events():
            q = self._queues.get(uid)
            if q is None or uid in self._closed:
                continue
            for t in np.asarray(toks).tolist():
                q.put_nowait(int(t))
        for uid in eng.pop_finished():
            fut = self._futs.get(uid)
            if fut is None:
                continue               # finished outside this front-end
            res = eng.result(uid)
            if not fut.done():
                fut.set_result(res)
            q = self._queues.get(uid)
            if q is not None and uid not in self._closed \
                    and not self._incremental and not res.cancelled:
                for t in np.asarray(res.tokens).tolist():
                    q.put_nowait(int(t))
            self._close_stream(uid)

    # -- internals ------------------------------------------------------
    def _close_stream(self, uid: int) -> None:
        if uid in self._closed:
            return
        self._closed.add(uid)
        q = self._queues.get(uid)
        if q is not None:
            q.put_nowait(_DONE)

    def _fail_all(self, e: BaseException) -> None:
        for fut in self._futs.values():
            if not fut.done():
                fut.set_exception(e)
        for uid in list(self._queues):
            self._close_stream(uid)

    def _require_ok(self) -> None:
        if self._error is not None:
            raise RuntimeError("serving pump failed") from self._error
        if self._task is None:
            raise RuntimeError("front-end not started "
                               "(use 'async with' or await start())")
