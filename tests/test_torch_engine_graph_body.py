"""The serving engine's macro body in the shape a CUDA graph captures.

On the card each macro launch replays one captured graph of
``ServeEngine._macro_step``; a replay runs no Python, reads and writes
fixed addresses and cannot wait for the host. Here, on the CPU, the same
body runs eagerly, and over runs with admissions, finishes and refills:

- every tensor of ``EngineState``, of its cache and of the body's static
  inputs (noise, frontier, evidence rows) keeps its storage across every
  launch;
- the body makes no host sync: ``Tensor.item``, ``tolist``, ``cpu``,
  ``numpy``, ``__bool__``, ``__int__`` and ``__float__`` raise while it
  runs;
- the static noise buffer, filled before each launch, gives the streams
  of the legacy per-token loop, which draws each step's noise when it
  runs, under the reference's fold-in draws (``ReferenceNoise``) and the
  port's ``GumbelNoise``, for K 1, 4 and 8 (both sources are stateless in
  the global step, so streams do not depend on K);
- the speculative body (spec_k 4) keeps every storage and makes no host
  sync either, its acceptance uniforms staged in a static buffer too;
- so does a run that streams tokens, cancels running requests at pump
  boundaries (their slots deactivated and their block-table rows pointed
  at the quarantine page in place) and admits requests that arrive
  mid-flight through ``pump``: a cancel that rebound a state tensor would
  leave a replay decoding the dead slot into pages the pool has handed on.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import config as tconfig
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServeEngine
# the reference engine's Gumbel draws; the fixtures: the tiny model pair
# and one torch thread (autouse)
from test_torch_engine_camd import (ReferenceNoise,  # noqa: F401
                                    _one_torch_thread, tiny)

CAMD = dict(samples_per_round=2, max_rounds=3, min_samples=2,
            max_clusters=8)
SYNCS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
         "__float__")


def _engine(model, impl, K, noise=None, mode="camd", max_new=8, spec_k=0):
    # 6 slots take 3 requests' first rounds: the 4th request and later
    # rounds refill slots that finished
    return ServeEngine(model, slots=6, cache_len=64, impl=impl, mode=mode,
                       n_candidates=3, max_new_tokens=max_new,
                       eos_id=model.cfg.vocab_size, seed=0, macro_steps=K,
                       paged_kv=tconfig.PagedKVConfig(page_size=8),
                       sampling=tconfig.SamplingConfig(
                           max_new_tokens=max_new, temperature=0.8),
                       camd=tconfig.CAMDConfig(**CAMD), noise=noise,
                       spec_k=spec_k)


def _submit(eng, evidence=None):
    rng = np.random.default_rng(1)
    for i, n in enumerate((6, 9, 6, 20)):
        eng.submit(Request(uid=i, prompt=rng.integers(
            2, eng.V, n).astype(np.int32),
            evidence=None if evidence is None else
            rng.standard_normal(evidence).astype(np.float32)))


def _tensors(eng):
    """Every tensor a replay reads or writes: the state's, its cache's and
    the body's static inputs."""
    st = eng.state
    out = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)
           if f.name != "cache"}
    out.update({f"cache.{k}": v for k, v in st.cache.items()})
    for name in ("_noise_buf", "_unif_buf", "_frontier", "_evid"):
        if getattr(eng, name) is not None:
            out[name] = getattr(eng, name)
    return out


@contextlib.contextmanager
def _no_host_sync():
    def refuse(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"host sync in the macro body: "
                                 f"Tensor.{name}")
        return fn
    saved = {n: getattr(torch.Tensor, n) for n in SYNCS}
    for n in SYNCS:
        setattr(torch.Tensor, n, refuse(n))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)


@pytest.fixture(scope="module")
def llava():
    """The port's reduced llava-1.5-7b at one layer, random weights: a
    model whose body reads the static evidence rows."""
    cfg = get_config("llava-1.5-7b").reduced().with_overrides(
        num_layers=1, dtype="float32")
    return build_model(cfg, torch.float32, device="cpu", seed=0)


@pytest.mark.parametrize("impl", ["torch", "paged", "paged_cuda"])
@pytest.mark.parametrize("arch,spec_k", [("tiny", 0), ("llava", 0),
                                         ("tiny", 4), ("llava", 4)])
def test_macro_body_keeps_storage_and_makes_no_sync(tiny, llava, arch,
                                                    spec_k, impl):
    model = tiny[3] if arch == "tiny" else llava
    eng = _engine(model, impl, 4, spec_k=spec_k)
    ev = None if arch == "tiny" else \
        (model.cfg.num_evidence_tokens,
         model.cfg.evidence_dim or model.cfg.d_model)
    _submit(eng, ev)
    ptrs = {k: t.data_ptr() for k, t in _tensors(eng).items()}
    body = eng._macro_step
    calls = []

    def checked():
        with _no_host_sync():
            out = body()
        now = {k: t.data_ptr() for k, t in _tensors(eng).items()}
        assert now == ptrs, {k for k in now if now[k] != ptrs[k]}
        calls.append(1)
        return out

    eng._macro_step = checked
    with torch.inference_mode():
        res = eng.run()
    assert len(res) == 4 and all(r.n_candidates > 0 for r in res)
    assert len(calls) == eng.macro_launches > 1
    # admissions, finishes and refills happened between launches
    assert eng.scheduler.stats()["admitted_candidates"] > eng.B
    assert eng._steps_launched == 4 * eng.macro_launches >= eng.total_steps
    assert (eng.spec_drafted > 0) == (spec_k > 0)
    if eng.paged:
        eng.pool.check()
        assert eng.pool.in_use == 0


@pytest.mark.parametrize("source", ["reference", "gumbel"])
def test_static_noise_buffer_keeps_streams(tiny, source):
    """Macro launches of K 1, 4 and 8 (noise staged in the static buffer)
    give the legacy loop's streams (noise drawn at each step), dense and
    paged."""
    model = tiny[3]

    def noise():
        return ReferenceNoise(0) if source == "reference" else None

    for impl in ("torch", "paged"):
        streams = {}
        for K in (0, 1, 4, 8):
            eng = _engine(model, impl, K, noise())
            _submit(eng)
            with torch.inference_mode():
                res = sorted(eng.run(), key=lambda r: r.uid)
            streams[K] = [[c["tokens"].tolist() for c in r.candidates]
                          for r in res]
        for K in (1, 4, 8):
            assert streams[K] == streams[0], (impl, K)


@pytest.mark.parametrize("impl", ["torch", "paged", "paged_cuda"])
@pytest.mark.parametrize("arch,spec_k", [("tiny", 0), ("llava", 0),
                                         ("tiny", 4)])
def test_body_keeps_storage_across_cancels_and_pumps(tiny, llava, arch,
                                                     spec_k, impl):
    """Pumped launch by launch with streaming on: requests cancelled while
    running, one cancelled while queued, one submitted mid-flight; every
    tensor a replay touches keeps its storage at every launch and after
    the drain, and the body makes no host sync."""
    model = tiny[3] if arch == "tiny" else llava
    eng = _engine(model, impl, 2, spec_k=spec_k)
    eng.stream_tokens = True
    ev = None if arch == "tiny" else \
        (model.cfg.num_evidence_tokens,
         model.cfg.evidence_dim or model.cfg.d_model)
    _submit(eng, ev)
    ptrs = {k: t.data_ptr() for k, t in _tensors(eng).items()}
    body = eng._macro_step
    calls = []

    def checked():
        with _no_host_sync():
            out = body()
        now = {k: t.data_ptr() for k, t in _tensors(eng).items()}
        assert now == ptrs, {k for k in now if now[k] != ptrs[k]}
        calls.append(1)
        return out

    eng._macro_step = checked
    late = Request(uid=9, prompt=np.arange(2, 9, dtype=np.int32),
                   evidence=None if ev is None else np.random.default_rng(
                       9).standard_normal(ev).astype(np.float32))
    assert eng.cancel(3)                         # queued: dropped at once
    events, i = [], 0
    with torch.inference_mode():
        while True:
            more = eng.pump()
            events += eng.drain_stream_events()
            if i == 0:
                assert eng.cancel(0)             # running: at the boundary
                eng.submit(late)                 # arrives mid-flight
            if i == 2:
                eng.cancel(1)
            i += 1
            if not more:
                break
    now = {k: t.data_ptr() for k, t in _tensors(eng).items()}
    assert now == ptrs
    res = {u: eng.result(u) for u in (0, 1, 2, 3, 9)}
    assert res[0].cancelled and res[3].cancelled
    assert not res[2].cancelled and res[9].n_candidates > 0
    assert eng.cancelled_requests >= 2 and events
    assert len(calls) == eng.macro_launches > 2
    assert not bool(eng.state.active.any())
    if eng.paged:
        eng.pool.check()
        assert eng.pool.in_use == 0 and eng._reserved == 0
        # torn-down and finished slots write only the quarantine page
        assert bool((eng.state.cache["block_table"] ==
                     eng.pool.quarantine_page()).all())
