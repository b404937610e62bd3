"""Speculative decoding in the port's serving engine against the JAX
engine's, at spec_k 4 and 8 steps a launch.

Both engines draft from the same n-gram table, verify with one block
forward per iteration and accept through the same rule, the port drawing
the reference engine's own noise (``ReferenceNoise``: each global step's
Gumbel row and its acceptance uniforms). So in every configuration —
greedy on the dense and paged plain impls under both scheduling
policies, CAMD sampling in both ``spec_mode``s, the prefix cache with
chunked prefill, an int8 pool, reduced llava with evidence and
cross-modal rescoring, reduced granite-moe (its MoE routes each verify
block's 24 tokens as one group, capacity binding) — the streams, rounds,
candidate counts, tokens spent, p* (1e-5), drafts proposed and accepted
and (steps, launches, host syncs) are equal (the two model configurations
are in ``tests/test_torch_engine_spec_models.py``, which runs on this
file's harness). Random weights need not
continue a prompt (fault R2 in ROADMAP), so one model is built to accept
every draft: the tiny model with its attention and MLP output projections
zeroed and its tied embedding rows scaled to one norm, whose greedy next
token is always the token fed.

Reference engines that differ only in host-side policy (scheduling
policy, ``spec_mode``, the prefix cache and chunking, the KV dtype, the
weights) share their jitted device functions (``_shared``): the same
closures over the same device-side configuration, compiled once, where
each engine would trace and compile them again.
"""
import jax
import jax.numpy as jnp
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
from repro_torch.serving.engine import Request, ServeEngine
# the reference engine's draws; the fixtures: the tiny model pair and one
# torch thread (autouse)
from test_torch_engine_camd import (ReferenceNoise,  # noqa: F401
                                    _one_torch_thread, tiny)

CAMD = dict(samples_per_round=2, max_rounds=3, min_samples=2,
            max_clusters=8)
TOL = dict(rtol=1e-5, atol=1e-5)
# the jitted device functions a reference engine serves with; the macro
# body also depends on whether every row is greedy (mode "greedy")
JIT_FNS = ("_macro_fn", "_prefill_fn", "_bucket_fn", "_first_fn",
           "_suffix_fn", "_round_fn")
_SHARED = {}


def _shared(key, jeng):
    """Give ``jeng`` the jitted device functions of the first reference
    engine built under ``key``, which names the model config and impl;
    every engine here shares the rest of its device-side configuration
    (``_kw``'s slots, cache length, K and spec_k, the page size, sampling
    and CAMD configs)."""
    for name in JIT_FNS:
        fn = getattr(jeng, name)
        if fn is not None:
            sub = (key, jeng.mode == "greedy") if name == "_macro_fn" \
                else key
            setattr(jeng, name, _SHARED.setdefault((sub, name), fn))
    return jeng


def _kw(cfg, mode, sched="fifo", **kw):
    return dict(slots=6, cache_len=64, mode=mode, n_candidates=3,
                max_new_tokens=8, eos_id=cfg.vocab_size, seed=0,
                macro_steps=8, sched_policy=sched, spec_k=4, **kw)


def _prompts(cfg, lens=(6, 9, 6, 20), shared=0, seed=1):
    """Random prompts of ``lens`` tokens; with ``shared``, every prompt
    starts with the first one's first ``shared`` tokens."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(2, cfg.vocab_size, n).astype(np.int32) for n in lens]
    for p in out[1:]:
        p[:shared] = out[0][:shared]
    return out


def _serve(pair, key, *, ref_impl, impl, mode, requests=None, kv_dtype="auto",
           params=None, waves=1, **kw):
    """Run the reference engine and the port's on the same requests (the
    prompts of ``_prompts``, or ``requests(req_cls)``), submitted
    ``waves`` times, each wave run to its end; returns (reference
    results, port results, reference engine, port engine)."""
    jcfg, jmodel, jparams, model = pair
    if params is not None:
        jparams = params
        model.load_state_dict(params_from_jax(
            jax.tree.map(np.asarray, params), model.cfg))
    common = _kw(jcfg, mode, **kw)
    jeng = _shared(key, JEngine(
        jmodel, jparams, impl=ref_impl,
        paged_kv=JPaged(page_size=8, kv_dtype=kv_dtype),
        sampling=JSampling(max_new_tokens=8, temperature=0.8),
        camd=JCAMD(**CAMD), **common))
    eng = ServeEngine(model, impl=impl,
                      paged_kv=tconfig.PagedKVConfig(page_size=8,
                                                     kv_dtype=kv_dtype),
                      sampling=tconfig.SamplingConfig(max_new_tokens=8,
                                                      temperature=0.8),
                      camd=tconfig.CAMDConfig(**CAMD),
                      noise=ReferenceNoise(0), **common)
    res = []
    for e, req_cls in ((jeng, JRequest), (eng, Request)):
        for w in range(waves):
            reqs = requests(req_cls) if requests else \
                [req_cls(uid=i, prompt=p)
                 for i, p in enumerate(_prompts(jcfg))]
            for r in reqs:
                r.uid += 100 * w
                e.submit(r)
            with torch.inference_mode():
                done = e.run()          # every wave's requests so far
        res.append(sorted(done, key=lambda r: r.uid))
    exp, out = res
    assert len(out) == len(exp) == waves * len(reqs)
    for a, b in zip(exp, out):
        assert (a.n_candidates, a.rounds, a.tokens_spent, a.stopped_early) \
            == (b.n_candidates, b.rounds, b.tokens_spent, b.stopped_early)
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
        assert [c["tokens"].tolist() for c in a.candidates] == \
            [c["tokens"].tolist() for c in b.candidates]
        assert [c.get("cluster") for c in a.candidates] == \
            [c.get("cluster") for c in b.candidates]
        np.testing.assert_allclose(a.p_star, b.p_star, **TOL)
    assert eng.spec and eng.spec_drafted > 0
    assert (eng.spec_drafted, eng.spec_accepted) == \
        (jeng.spec_drafted, jeng.spec_accepted)
    assert (eng.total_steps, eng.macro_launches, eng.host_syncs) == \
        (jeng.total_steps, jeng.macro_launches, jeng.host_syncs)
    if eng.paged:
        eng.pool.check()
        cached = eng.pool.prefix.cached_pages if eng.pool.prefix else 0
        assert eng.pool.in_use == cached and eng._reserved == 0
    return exp, out, jeng, eng


@pytest.mark.parametrize("sched", ["fifo", "coverage"])
@pytest.mark.parametrize("ref_impl,impl", [("xla", "torch"),
                                           ("paged", "paged")])
def test_greedy_spec_equals_reference(tiny, ref_impl, impl, sched):
    _serve(tiny, f"tiny {ref_impl}", ref_impl=ref_impl, impl=impl,
           mode="greedy", sched=sched)


@pytest.mark.parametrize("spec_mode,sched", [("coverage", "coverage"),
                                             ("fixed", "fifo")])
def test_camd_spec_equals_reference(tiny, spec_mode, sched):
    """Sampled candidates under the reference's draws; in "coverage" mode
    a later round's candidates verify narrower blocks as p* rises."""
    _, out, _, eng = _serve(tiny, "tiny paged", ref_impl="paged",
                            impl="paged", mode="camd", sched=sched,
                            spec_mode=spec_mode)
    assert sum(r.rounds for r in out) > len(out)       # some went again


def test_spec_prefix_cache_and_chunks_equal_reference(tiny):
    """24-token prompts sharing 17, in two waves: chunks of 16 stream them
    in, and the second wave hits the first one's cached pages."""
    jcfg = tiny[0]

    def requests(req_cls):
        return [req_cls(uid=i, prompt=p) for i, p in enumerate(
            _prompts(jcfg, lens=(24,) * 4, shared=17))]

    _, _, jeng, eng = _serve(tiny, "tiny paged", ref_impl="paged",
                             impl="paged", mode="camd", requests=requests,
                             prefix_cache=True, prefill_chunk=16, waves=2)
    assert eng.chunk_calls == jeng.chunk_calls > 0
    assert eng.kv_stats()["prefix_cache"]["hits"] == \
        jeng.kv_stats()["prefix_cache"]["hits"] > 0


def test_spec_int8_pool_equals_reference(tiny):
    _serve(tiny, "tiny paged", ref_impl="paged", impl="paged",
           mode="greedy", kv_dtype="int8")


def _repeating(jparams):
    """The tiny model's params with attention and MLP output projections
    zeroed, so the final hidden state is the fed token's embedding, and
    the tied embedding rows scaled to one norm, so that by Cauchy-Schwarz
    the greedy next token is the token fed."""
    blk = dict(jparams["super"][0])
    blk["attn"] = dict(blk["attn"], wo={"kernel": jnp.zeros_like(
        blk["attn"]["wo"]["kernel"])})
    blk["mlp"] = dict(blk["mlp"], w_down={"kernel": jnp.zeros_like(
        blk["mlp"]["w_down"]["kernel"])})
    table = jparams["embed"]["table"]
    table = table / jnp.linalg.norm(table, axis=-1, keepdims=True)
    return dict(jparams, super=(blk,), embed={"table": table})


def test_spec_accepts_every_draft_on_a_repeating_model(tiny):
    jcfg, _, jparams, model = tiny
    params = _repeating(jparams)
    try:
        exp, out, jeng, eng = _serve(tiny, "tiny paged",
                                     ref_impl="paged", impl="paged",
                                     mode="greedy", params=params)
    finally:
        model.load_state_dict(params_from_jax(
            jax.tree.map(np.asarray, jparams), model.cfg))
    prompts = _prompts(jcfg)
    for r, p in zip(out, prompts):
        assert r.tokens.tolist() == [int(p[-1])] * 8
    assert eng.spec_accepted > 0
    # every draft proposed inside the token limit was accepted: 8 tokens
    # a candidate in fewer than 8 verify iterations
    assert eng.total_steps < 8 * len(out)
