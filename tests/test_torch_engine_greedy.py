"""The port's serving engine against the JAX package's: greedy streams.

The reference ``ServeEngine`` and the port's serve the same prompts with
the same weights (carried over by ``params_from_jax``) and an eos id
outside the vocab, so every candidate runs to its limit. Greedy token
streams must be equal token for token, dense and paged, in the legacy
per-token loop and in macro-steps of K = 1 and 8. Inside the port, paged
streams equal dense ones bit for bit and streams do not depend on K.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import CAMDConfig as JCAMD
from repro.config import PagedKVConfig as JPaged
from repro.config import SamplingConfig as JSampling
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JEngine
from repro_torch import config as tconfig
from repro_torch.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServeEngine
from torch_ranks import _one_torch_thread  # noqa: F401

PLENS = (6, 6, 20)          # two prompts share a bucket, one goes to 32


@pytest.fixture(scope="module")
def tiny(tiny_model):
    jcfg, jmodel, jparams = tiny_model
    cfg = tconfig.ModelConfig(**{f.name: getattr(jcfg, f.name) for f in
                                 dataclasses.fields(tconfig.ModelConfig)})
    model = build_model(cfg, torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg))
    return jcfg, jmodel, jparams, model


def _common(cfg, mode, K, max_new=8):
    return dict(slots=6, cache_len=64, mode=mode, n_candidates=3,
                max_new_tokens=max_new, eos_id=cfg.vocab_size, seed=0,
                macro_steps=K)


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
            for n in PLENS]


def run_ref(jmodel, jparams, cfg, *, impl, mode, K):
    eng = JEngine(jmodel, jparams, impl=impl, paged_kv=JPaged(page_size=8),
                  sampling=JSampling(max_new_tokens=8, temperature=0.8),
                  camd=JCAMD(samples_per_round=2, max_rounds=2,
                             min_samples=2, max_clusters=8),
                  **_common(cfg, mode, K))
    for i, p in enumerate(_prompts(cfg)):
        eng.submit(JRequest(uid=i, prompt=p))
    return sorted(eng.run(), key=lambda r: r.uid), eng


def run_port(model, cfg, *, impl, mode, K, noise=None):
    eng = ServeEngine(model, impl=impl,
                      paged_kv=tconfig.PagedKVConfig(page_size=8),
                      sampling=tconfig.SamplingConfig(max_new_tokens=8,
                                                      temperature=0.8),
                      camd=tconfig.CAMDConfig(samples_per_round=2,
                                              max_rounds=2, min_samples=2,
                                              max_clusters=8),
                      noise=noise, **_common(cfg, mode, K))
    for i, p in enumerate(_prompts(cfg)):
        eng.submit(Request(uid=i, prompt=p))
    with torch.inference_mode():
        res = sorted(eng.run(), key=lambda r: r.uid)
    if eng.paged:
        eng.pool.check()
        assert eng.pool.in_use == 0 and eng._reserved == 0
    return res, eng


def assert_same(a_res, b_res):
    assert len(a_res) == len(b_res) == len(PLENS)
    for a, b in zip(a_res, b_res):
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
        assert (a.n_candidates, a.rounds, a.tokens_spent) == \
            (b.n_candidates, b.rounds, b.tokens_spent)
        assert [c["tokens"].tolist() for c in a.candidates] == \
            [c["tokens"].tolist() for c in b.candidates]


@pytest.mark.parametrize("K", [0, 1, 8])
@pytest.mark.parametrize("ref_impl,impl", [("xla", "torch"),
                                           ("paged", "paged")])
def test_greedy_streams_equal_reference(tiny, ref_impl, impl, K):
    jcfg, jmodel, jparams, model = tiny
    exp, jeng = run_ref(jmodel, jparams, jcfg, impl=ref_impl, mode="greedy",
                        K=K)
    out, eng = run_port(model, jcfg, impl=impl, mode="greedy", K=K)
    assert_same(exp, out)
    assert all(len(r.tokens) == 8 for r in out)   # eos outside the vocab
    # the macro loop exits where the reference's while_loop does
    assert (eng.total_steps, eng.macro_launches, eng.host_syncs) == \
        (jeng.total_steps, jeng.macro_launches, jeng.host_syncs)


def test_greedy_paged_kernel_impl_equals_reference(tiny):
    """The paged kernel impl (its plain version on CPU tensors) serves the
    same greedy streams as the reference's Pallas paged impl."""
    jcfg, jmodel, jparams, model = tiny
    exp, _ = run_ref(jmodel, jparams, jcfg, impl="paged_pallas",
                     mode="greedy", K=8)
    out, _ = run_port(model, jcfg, impl="paged_cuda", mode="greedy", K=8)
    assert_same(exp, out)


@pytest.mark.parametrize("mode", ["camd", "self_consistency"])
def test_port_paged_equals_dense_and_k_invariant(tiny, mode):
    """Within the port, with its own noise source: paged streams equal
    dense ones bit for bit, and macro-K (0 = the per-token loop) does not
    change any stream."""
    jcfg, _, _, model = tiny
    base, _ = run_port(model, jcfg, impl="torch", mode=mode, K=8)
    for impl, K in (("paged", 8), ("torch", 0), ("paged", 32)):
        out, _ = run_port(model, jcfg, impl=impl, mode=mode, K=K)
        assert_same(base, out)
