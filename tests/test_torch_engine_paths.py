"""The port's serving engine against the JAX package's on engine paths
that ``tests/test_torch_engine_camd.py`` leaves out: ``best_of_n``, CAMD
under a stream-wide token budget (the fifo policy starves the last
requests, the coverage policy shares it out), and the full
sampling-processor chain (top-k, top-p, min-p, repetition penalty).

The same ``tiny_model`` weights, prompts and Gumbel draws (the reference
engine's own keys, ``ReferenceNoise``) go through both engines, so
streams, candidate counts, rounds, p*, the starved requests and the
engine's telemetry (decode steps, macro launches, host syncs) must be
equal.
"""
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
# the reference engine's Gumbel draws and the sampled test's setup; the
# fixtures: the tiny model pair and one torch thread (autouse)
from test_torch_engine_camd import (ReferenceNoise, _kw, _submit,  # noqa
                                    _one_torch_thread, tiny)

CAMD = dict(samples_per_round=2, max_rounds=3, min_samples=2,
            max_clusters=8)
CHAIN = dict(top_k=5, top_p=0.8, min_p=0.05, repetition_penalty=1.2)

# (reference impl, port impl, mode, macro steps K (0: the legacy
# per-token loop), scheduler, global budget, sampling overrides)
CASES = {
    "best_of_n-xla-fifo-K8": ("xla", "torch", "best_of_n", 8, "fifo", 0,
                              {}),
    "best_of_n-paged-coverage-K0": ("paged", "paged", "best_of_n", 0,
                                    "coverage", 0, {}),
    "budget30-xla-K8": ("xla", "torch", "camd", 8, "fifo", 30, {}),
    "budget45-xla-K0": ("xla", "torch", "camd", 0, "fifo", 45, {}),
    "budget40-paged-K8": ("paged", "paged", "camd", 8, "fifo", 40, {}),
    "budget30-paged-K0": ("paged", "paged", "camd", 0, "fifo", 30, {}),
    # the coverage policy fair-shares the budget: nothing starves
    "budget50-paged-coverage-K8": ("paged", "paged", "camd", 8, "coverage",
                                   50, {}),
    "processor-chain-paged-K8": ("paged", "paged", "camd", 8, "fifo", 0,
                                 CHAIN),
}


def _run(make, req_cls, cfg):
    eng = make()
    _submit(eng, req_cls, cfg)
    return sorted(eng.run(), key=lambda r: r.uid), eng


@pytest.mark.parametrize("case", list(CASES))
def test_engine_path_equals_reference(tiny, case):
    ref_impl, impl, mode, K, sched, budget, chain = CASES[case]
    jcfg, jmodel, jparams, model = tiny
    sampling = dict(max_new_tokens=8, temperature=0.8, **chain)
    kw = dict(_kw(jcfg, mode, K, sched), global_budget=budget)
    exp, jeng = _run(lambda: JEngine(
        jmodel, jparams, impl=ref_impl, paged_kv=JPaged(page_size=8),
        sampling=JSampling(**sampling), camd=JCAMD(**CAMD), **kw),
        JRequest, jcfg)
    with torch.inference_mode():
        out, eng = _run(lambda: ServeEngine(
            model, impl=impl, paged_kv=tconfig.PagedKVConfig(page_size=8),
            sampling=tconfig.SamplingConfig(**sampling),
            camd=tconfig.CAMDConfig(**CAMD),
            noise=ReferenceNoise(0, legacy=K == 0), **kw), Request, jcfg)
    assert len(out) == len(exp) == 4
    for a, b in zip(exp, out):
        assert (a.n_candidates, a.rounds, a.tokens_spent,
                a.stopped_early) == (b.n_candidates, b.rounds,
                                     b.tokens_spent, b.stopped_early)
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
        assert [c["tokens"].tolist() for c in a.candidates] == \
            [c["tokens"].tolist() for c in b.candidates]
        for ca, cb in zip(a.candidates, b.candidates):
            assert ca["cluster"] == cb["cluster"]
            np.testing.assert_allclose(ca["score"], cb["score"], rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(a.p_star, b.p_star, rtol=1e-5, atol=1e-5)
    assert eng.starved_uids == jeng.starved_uids
    if budget:
        assert bool(eng.starved_uids) == (sched == "fifo")
        assert sum(r.tokens_spent for r in out) <= budget
    assert (eng.total_steps, eng.macro_launches, eng.host_syncs) == \
        (jeng.total_steps, jeng.macro_launches, jeng.host_syncs)
    if eng.paged:
        eng.pool.check()
        assert eng.pool.in_use == 0 and eng._reserved == 0
