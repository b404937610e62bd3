"""The port's open-loop traffic module against the JAX package's.

``repro_torch.serving.traffic`` is a copy of ``repro.serving.traffic``:
on the same seeds its arrival processes give the same times, and on the
same fake-clock traces its percentile and SLO math gives the same numbers
(TTFT by prompt-length bucket included), bit for bit.
"""
import dataclasses

import numpy as np
import pytest

from repro.serving import traffic as jtraffic
from repro_torch.serving import traffic
from torch_ranks import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ["poisson", "bursty"])
@pytest.mark.parametrize("rate,n,seed", [(0.0, 4, 0), (3.5, 16, 11),
                                         (40.0, 64, 13)])
def test_arrivals_equal_reference(name, rate, n, seed):
    got = traffic.ARRIVALS[name](rate, n, seed=seed)
    exp = jtraffic.ARRIVALS[name](rate, n, seed=seed)
    np.testing.assert_array_equal(got, exp)
    assert got.dtype == np.float64 and got.shape == (n,)
    assert np.all(np.diff(got) >= 0)
    assert sorted(traffic.ARRIVALS) == sorted(jtraffic.ARRIVALS)


def test_bursty_options_equal_reference():
    for kw in (dict(burst=2.0, on_frac=0.5), dict(period_s=0.3),
               dict(burst=8.0, on_frac=0.1, period_s=2.0)):
        np.testing.assert_array_equal(
            traffic.bursty_arrivals(5.0, 40, 7, **kw),
            jtraffic.bursty_arrivals(5.0, 40, 7, **kw))
    for mod in (traffic, jtraffic):
        with pytest.raises(ValueError):
            mod.bursty_arrivals(5.0, 4, burst=0.0)


@pytest.mark.parametrize("xs", [[], [7.0], [1.0, 2.0, 3.0, 4.0],
                                [5.0, 1.0, 3.0, 9.5, 0.25, 3.0]])
def test_percentile_equals_reference(xs):
    for q in (0, 1, 25, 50, 75, 99, 100):
        got, exp = traffic.percentile(xs, q), jtraffic.percentile(xs, q)
        assert (np.isnan(got) and np.isnan(exp)) or got == exp


def _traces(mod, seed):
    """Fake-clock traces: random arrivals, queueing delays, token counts
    and prompt lengths, a few cancelled or unfinished."""
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(24):
        arr = float(rng.uniform(0, 5))
        first = arr + float(rng.exponential(0.3))
        n = int(rng.integers(1, 40))
        done = first + n * float(rng.uniform(0.005, 0.05))
        out.append(mod.RequestTrace(
            uid=uid, t_arrival=arr, t_submit=arr, t_first=first,
            t_done=None if uid % 11 == 5 else done, n_tokens=n,
            prompt_len=int(rng.integers(1, 600)),
            cancelled=uid % 7 == 3))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [
    dict(slo_ttft_ms=250.0),
    dict(slo_ttft_ms=400.0, span_s=6.0),
    dict(slo_ttft_ms=300.0, length_buckets=(64, 256)),
    dict(slo_ttft_ms=300.0, length_buckets=(18,)),
], ids=["default", "span", "buckets", "one_bound"])
def test_slo_metrics_equal_reference(seed, kw):
    got = traffic.slo_metrics(_traces(traffic, seed), **kw)
    exp = jtraffic.slo_metrics(_traces(jtraffic, seed), **kw)
    assert got == exp
    assert got["cancelled"] > 0 and got["completed"] > 0
    if "length_buckets" in kw:
        assert sum(b["n"] for b in got["ttft_by_bucket"].values()) == \
            got["completed"]


def test_request_trace_fields_equal_reference():
    assert [(f.name, f.default) for f in
            dataclasses.fields(traffic.RequestTrace)] == \
        [(f.name, f.default) for f in
         dataclasses.fields(jtraffic.RequestTrace)]
    for mod in (traffic, jtraffic):
        with pytest.raises(AssertionError):
            mod.slo_metrics([], slo_ttft_ms=1.0, length_buckets=(64, 8))
