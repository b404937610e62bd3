"""Open-loop traffic: arrival processes, SLO metric math, and the
asyncio client loop that feeds an ``AsyncServeFrontend``.

Closed-loop benchmarking (pre-staged batches, ``ServeEngine.run``)
measures *capacity*; production serving is an **open-loop** arrival
process — requests arrive on their own clock whether or not the engine
is keeping up, so queueing delay compounds under load. The helpers here
make that measurable:

* ``poisson_arrivals`` / ``bursty_arrivals`` — deterministic (seeded)
  arrival-time generators. Bursty is an on/off-modulated Poisson
  process (a two-state MMPP): ON periods arrive ``burst``× faster than
  the mean rate, OFF periods are silent, with duty cycle chosen so the
  long-run mean rate matches ``rate``.
* ``drive_open_loop`` — submits each request at its *scheduled* arrival
  time, consumes its token stream, and records a ``RequestTrace``.
  Open-loop semantics: TTFT is measured from the scheduled arrival, so
  time spent queueing behind a saturated engine counts against the SLO
  (this is precisely what closed-loop numbers hide).
* ``slo_metrics`` — pure trace → metrics math (p50/p99 TTFT, p50/p99
  per-output-token latency, goodput at a TTFT SLO, tokens/s), unit-
  tested against hand-built fake-clock traces.

The port of ``repro/serving/traffic.py``, with the same seeds and the same
numbers. Its own imports are numpy and the standard library: the metric
math and the arrival generators need no device, and ``drive_open_loop`` only
touches the front-end's public coroutines (``run_open_loop`` imports the
front-end when called).
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class RequestTrace:
    """Per-request timeline, all times in seconds since
    ``drive_open_loop`` started."""
    uid: int
    t_arrival: float                 # scheduled arrival (open-loop)
    t_submit: float = 0.0            # when submit actually ran
    t_first: Optional[float] = None  # first stream output seen
    t_done: Optional[float] = None   # result available
    n_tokens: int = 0                # chosen candidate's tokens
    prompt_len: int = 0              # prompt tokens (TTFT bucketing)
    cancelled: bool = False


# ---------------------------------------------------------------------------
# arrival processes (seeded, deterministic)
# ---------------------------------------------------------------------------

def poisson_arrivals(rate: float, n: int, seed: int = 0) -> np.ndarray:
    """``n`` absolute arrival times (s) of a Poisson process of ``rate``
    requests/s: iid exponential inter-arrivals, cumulatively summed."""
    if rate <= 0:
        return np.zeros(n, np.float64)
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def bursty_arrivals(rate: float, n: int, seed: int = 0, *,
                    burst: float = 4.0, on_frac: float = 0.25,
                    period_s: Optional[float] = None) -> np.ndarray:
    """On/off-modulated Poisson arrivals with long-run mean ``rate``.

    The process alternates ON windows (arrival rate ``rate * burst``)
    and OFF windows (silent). ``on_frac`` is the ON duty cycle; the
    default ``burst=4, on_frac=0.25`` makes ON exactly 4× the mean rate
    with 75% silence — the same offered load as Poisson, concentrated.
    ``period_s`` is one ON+OFF cycle (default: the time 8 mean-rate
    arrivals take, so a run of ``n`` requests sees several bursts)."""
    if rate <= 0:
        return np.zeros(n, np.float64)
    if burst * on_frac <= 0:
        raise ValueError(f"burst={burst}, on_frac={on_frac}")
    rng = np.random.default_rng(seed)
    period = period_s if period_s is not None else 8.0 / rate
    on_len = period * on_frac
    out = np.empty(n, np.float64)
    t = 0.0              # position inside the current ON window
    cycle = 0
    for i in range(n):
        t += rng.exponential(1.0 / (rate * burst))
        while t >= on_len:
            t -= on_len
            cycle += 1
        out[i] = cycle * period + t
    return out


ARRIVALS: Dict[str, Callable[..., np.ndarray]] = {
    "poisson": poisson_arrivals,
    "bursty": bursty_arrivals,
}


# ---------------------------------------------------------------------------
# SLO metric math (pure, fake-clock testable)
# ---------------------------------------------------------------------------

def percentile(xs: Sequence[float], q: float) -> float:
    """Deterministic linear-interpolation percentile (numpy's default
    'linear' method, pinned here so the SLO gates never drift with a
    numpy version change). ``q`` in [0, 100]."""
    arr = np.sort(np.asarray(list(xs), np.float64))
    if arr.size == 0:
        return float("nan")
    if arr.size == 1:
        return float(arr[0])
    pos = (q / 100.0) * (arr.size - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, arr.size - 1)
    frac = pos - lo
    return float(arr[lo] * (1.0 - frac) + arr[hi] * frac)


def _bucket_label(b: int, bounds: Sequence[int]) -> str:
    """Human-stable bucket names: "lt64", "64to256", "ge256"."""
    if b == 0:
        return f"lt{bounds[0]}"
    if b == len(bounds):
        return f"ge{bounds[-1]}"
    return f"{bounds[b - 1]}to{bounds[b]}"


def slo_metrics(traces: Sequence[RequestTrace], *, slo_ttft_ms: float,
                span_s: Optional[float] = None,
                length_buckets: Sequence[int] = ()) -> Dict[str, object]:
    """SLO summary of an open-loop run.

    TTFT = first stream output minus *scheduled arrival* (queueing
    counts). TPOT = (t_done - t_first) / (n_tokens - 1) for requests
    with >= 2 tokens. Goodput = completed requests meeting the TTFT SLO
    per second of span; ``tokens_per_s`` counts completed requests'
    tokens over the same span. Cancelled requests are excluded from the
    latency distributions but reported.

    ``length_buckets``: ascending prompt-length boundaries (e.g.
    ``(64, 256)``) adding ``ttft_by_bucket`` — per-prompt-length-bucket
    TTFT percentiles keyed "lt64"/"64to256"/"ge256" — so a long-prompt
    tail improvement (chunked prefill's whole point) is visible instead
    of averaged away."""
    done = [t for t in traces
            if not t.cancelled and t.t_done is not None
            and t.t_first is not None]
    ttft_ms = [(t.t_first - t.t_arrival) * 1e3 for t in done]
    tpot_ms = [(t.t_done - t.t_first) / (t.n_tokens - 1) * 1e3
               for t in done if t.n_tokens >= 2]
    if span_s is None:
        t_end = max((t.t_done for t in done), default=0.0)
        t_start = min((t.t_arrival for t in traces), default=0.0)
        span_s = max(t_end - t_start, 1e-9)
    good = sum(1 for ms in ttft_ms if ms <= slo_ttft_ms)
    out: Dict[str, object] = {
        "completed": len(done),
        "cancelled": sum(1 for t in traces if t.cancelled),
        "span_s": span_s,
        "slo_ttft_ms": slo_ttft_ms,
        "ttft_p50_ms": percentile(ttft_ms, 50),
        "ttft_p99_ms": percentile(ttft_ms, 99),
        "tpot_p50_ms": percentile(tpot_ms, 50),
        "tpot_p99_ms": percentile(tpot_ms, 99),
        "goodput_rps": good / span_s,
        "good_requests": good,
        "tokens_per_s": sum(t.n_tokens for t in done) / span_s,
    }
    if length_buckets:
        bounds = list(length_buckets)
        assert bounds == sorted(bounds) and len(set(bounds)) == len(bounds), \
            f"length_buckets must be strictly ascending: {bounds}"
        by: Dict[str, List[float]] = {}
        for t in done:
            b = int(np.searchsorted(bounds, t.prompt_len, side="right"))
            by.setdefault(_bucket_label(b, bounds), []).append(
                (t.t_first - t.t_arrival) * 1e3)
        out["ttft_by_bucket"] = {
            label: {"n": len(xs),
                    "p50_ms": percentile(xs, 50),
                    "p99_ms": percentile(xs, 99)}
            for label, xs in sorted(by.items())}
    return out


# ---------------------------------------------------------------------------
# the open-loop client loop
# ---------------------------------------------------------------------------

async def drive_open_loop(frontend, requests: Sequence,
                          arrivals: Sequence[float], *,
                          clock: Callable[[], float] = time.monotonic,
                          cancel_uids: Sequence[int] = (),
                          cancel_after_tokens: int = 1,
                          ) -> List[RequestTrace]:
    """Submit each request at its scheduled arrival time, stream its
    tokens, and return one ``RequestTrace`` per request (input order).

    ``cancel_uids`` requests are aborted after ``cancel_after_tokens``
    streamed tokens (or immediately on completion if the stream closes
    first) — the client-disconnect path under real traffic. The
    front-end must already be started."""
    assert len(requests) == len(arrivals)
    t0 = clock()
    cancel_set = set(cancel_uids)
    traces = [RequestTrace(uid=r.uid, t_arrival=float(a),
                           prompt_len=len(r.prompt))
              for r, a in zip(requests, arrivals)]

    async def one(req, tr: RequestTrace):
        delay = tr.t_arrival - (clock() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        await frontend.submit(req)
        tr.t_submit = clock() - t0
        seen = 0
        async for _tok in frontend.stream(req.uid):
            now = clock() - t0
            if tr.t_first is None:
                tr.t_first = now
            seen += 1
            if req.uid in cancel_set and seen >= cancel_after_tokens:
                await frontend.cancel(req.uid)
        res = await frontend.result(req.uid)
        tr.t_done = clock() - t0
        tr.n_tokens = int(len(res.tokens))
        tr.cancelled = bool(res.cancelled)
        if tr.t_first is None and not tr.cancelled:
            # non-incremental mode delivered the whole result at once
            tr.t_first = tr.t_done
        return tr

    await asyncio.gather(*[one(r, t) for r, t in zip(requests, traces)])
    return traces


def run_open_loop(engine, requests: Sequence, arrivals: Sequence[float],
                  *, slo_ttft_ms: float, cancel_uids: Sequence[int] = (),
                  cancel_after_tokens: int = 1,
                  length_buckets: Sequence[int] = ()):
    """Synchronous wrapper: build a front-end on ``engine``, drive the
    open-loop schedule, and return ``(traces, metrics)``."""
    from repro_torch.serving.frontend import AsyncServeFrontend

    async def main():
        async with AsyncServeFrontend(engine) as fe:
            return await drive_open_loop(
                fe, requests, arrivals, cancel_uids=cancel_uids,
                cancel_after_tokens=cancel_after_tokens)

    traces = asyncio.run(main())
    return traces, slo_metrics(traces, slo_ttft_ms=slo_ttft_ms,
                               length_buckets=length_buckets)
