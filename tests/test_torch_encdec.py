"""The port's encoder-decoder path (seamless-m4t-large-v2) against the JAX
package's, on the CPU.

The reduced config (2 encoder and 2 decoder layers, d 256, 4/2 heads of
64, 8 evidence frames of width 256) in fp32, with the reference's weights
carried over by ``params_from_jax`` and inputs made by numpy from a
seed. Held within 1e-4 abs + 1e-4 rel (fp32 matrix products in another
summation order): the bidirectional and the cross-attention against the
reference's ``attn_prefill``/``attn_decode``, ``encode``, ``cross_kv``,
one encoder and one decoder block, ``Model.prefill`` and four
``decode_step``s (logits, hidden states and every cache leaf: ``k``/``v``
against ``self.{k,v}``, ``cross_k``, ``cross_v``, ``pos``) on the torch
and cuda impls (the kernels' plain versions here), and ``Model.forward``
with the gradients of a loss through it against ``jax.grad``. The serving
engine against the JAX engine, token for token: greedy at macro-steps of
4 and the per-token loop (K 0), and CAMD under the reference's Gumbel
draws at K 4 with and without ``xmodal_rescore`` (candidates, rounds,
tokens spent, clusters, p* and scores within 1e-4), each on both impls;
the step, launch and host-sync counts and the prefill accounting (the
evidence is not in the prompt span) equal the reference's. The paged
impls and the decoder-only serving paths are refused. The JAX engines
are built once a session.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CAMDConfig as JCAMD
from repro.config import SamplingConfig as JSampling
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import build_model as jbuild
from repro.models.layers import mlp as jmlp
from repro.models.layers import rmsnorm as jrmsnorm
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JEngine
from repro_torch import config as tconfig
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models.layers import mlp as tmlp
from repro_torch.models.layers import rmsnorm as trmsnorm
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServeEngine
from test_torch_engine_camd import ReferenceNoise
from torch_ranks import _one_torch_thread  # noqa: F401

NAME = "seamless-m4t-large-v2"
TOL = dict(rtol=1e-4, atol=1e-4)
IMPLS = ("torch", "cuda")
# random weights put every candidate of the reduced model in one cluster
# at the default threshold (0.85), so every request would stop after one
# round; at 0.95 they split, and requests run two or three rounds
CAMD = dict(samples_per_round=2, max_rounds=3, min_samples=2, max_clusters=8,
            cluster_threshold=0.95)
MAX_NEW = 6


@pytest.fixture(scope="session")
def pair():
    """(jcfg, jmodel, jparams, port model) at reduced() size in fp32."""
    jcfg = jget_config(NAME).reduced().with_overrides(dtype="float32")
    jmodel = jbuild(jcfg, jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = tconfig.ModelConfig(**{f.name: getattr(jcfg, f.name) for f in
                                 dataclasses.fields(tconfig.ModelConfig)})
    model = build_model(cfg, torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg))
    return jcfg, jmodel, jparams, model


def close(exp, out, tol=TOL):
    np.testing.assert_allclose(np.asarray(exp, np.float32),
                               out.detach().float().numpy(), **tol)


def t(a, dtype=None):
    return torch.from_numpy(np.array(a)).to(dtype) if dtype else \
        torch.from_numpy(np.array(a))


def _inputs(cfg, B, L, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    ev = rng.standard_normal((B, cfg.num_evidence_tokens,
                              cfg.evidence_dim)).astype(np.float32)
    return toks, ev


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_config_equals_reference():
    """Field for field the reference's under both spellings, full and
    reduced; the reference's parameter count (1,632,129,024 at full
    size); the reduced model's parameters under the converter's keys."""
    cfg = get_config(NAME)
    assert get_config("seamless_m4t_large_v2") is cfg
    assert NAME in list_configs()
    jcfg = jget_config(NAME)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert cfg.num_params() == jcfg.num_params() == 1_632_129_024
    assert cfg.reduced().num_params() == jcfg.reduced().num_params()
    model = build_model(cfg.reduced(), torch.bfloat16, device="cpu")
    jp = jbuild(jcfg.reduced(), jnp.bfloat16).init(jax.random.PRNGKey(0))
    flat = params_from_jax(jax.tree.map(np.asarray, jp), cfg.reduced())
    params = dict(model.named_parameters())
    assert set(flat) == set(params)
    assert {"enc_norm.scale", "dec_layers.1.xattn.wq.kernel",
            "dec_layers.0.lnx.scale", "enc_layers.1.mlp.w_in.kernel",
            "unembed.kernel"} <= set(params)
    for key, val in flat.items():
        assert val.shape == params[key].shape and \
            val.dtype == params[key].dtype == torch.bfloat16, key


# ---------------------------------------------------------------------------
# attention, encoder, blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_bidirectional_and_cross_attention_match(pair, impl):
    """``attn_prefill(causal=False)`` (the encoder's) on both impls, and the
    cross-attention at prefill (L 5) and decode (L 1), against the
    reference's ``attn_prefill``/``attn_decode`` with ``cross_kv``."""
    jcfg, _, jparams, model = pair
    rng = np.random.default_rng(1)
    B, L, Ne = 2, 5, jcfg.num_evidence_tokens
    x = rng.standard_normal((B, Ne, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Ne, dtype=np.int32), (B, Ne))
    jp = _layer(jparams["enc_super"], 0)["attn"]
    exp, (jk, jv) = jattn.attn_prefill(jp, jcfg, jnp.asarray(x),
                                       jnp.asarray(pos), causal=False)
    with torch.inference_mode():
        out, (k, v) = tattn.attn_prefill(model.enc_layers[0].attn, model.cfg,
                                         t(x), t(pos, torch.long),
                                         impl=impl, causal=False)
    close(exp, out)
    close(jk, k)
    close(jv, v)
    jx = _layer(jparams["dec_super"], 1)["xattn"]
    blk = model.dec_layers[1].xattn
    hd = jcfg.resolved_head_dim
    ck, cv = (rng.standard_normal((B, Ne, jcfg.num_kv_heads, hd)).astype(
        np.float32) for _ in range(2))
    for n in (L, 1):
        h = rng.standard_normal((B, n, jcfg.d_model)).astype(np.float32)
        if n == 1:
            exp, _ = jattn.attn_decode(jx, jcfg, jnp.asarray(h), None,
                                       jnp.zeros((B,), jnp.int32),
                                       cross_kv=(jnp.asarray(ck),
                                                 jnp.asarray(cv)))
        else:
            exp, _ = jattn.attn_prefill(
                jx, jcfg, jnp.asarray(h), jnp.zeros((B, n), jnp.int32),
                cross_kv=(jnp.asarray(ck), jnp.asarray(cv)))
        with torch.inference_mode():
            out = tattn.cross_attend(blk, model.cfg, t(h), t(ck), t(cv))
        close(exp, out)


def test_encode_cross_kv_and_blocks_match(pair):
    """``encode`` and ``cross_kv`` of seeded evidence, one encoder block
    (ln1, bidirectional attention, ln2, gelu MLP) and one decoder block
    (``_dec_block``: causal self-attention, cross-attention, MLP) against
    the reference's."""
    jcfg, _, jparams, model = pair
    cfg = model.cfg
    toks, ev = _inputs(jcfg, 2, 7, 2)
    mem = jencdec.encode(jparams, jcfg, jnp.asarray(ev))
    jck, jcv = jencdec._cross_kv(jparams["dec_super"]["xattn"], jcfg, mem)
    with torch.inference_mode():
        tmem = tencdec.encode(model, t(ev))
        ck, cv = tencdec.cross_kv(model, tmem)
    close(mem, tmem)
    close(jck, ck)
    close(jcv, cv)
    # one encoder block on the evidence
    jp = _layer(jparams["enc_super"], 1)
    x = jnp.asarray(ev)
    pos = jnp.broadcast_to(jnp.arange(ev.shape[1]), ev.shape[:2])
    y, _ = jattn.attn_prefill(jp["attn"], jcfg,
                              jrmsnorm(jp["ln1"], x, jcfg.norm_eps), pos,
                              causal=False)
    x = x + y
    exp = x + jmlp(jp["mlp"], jrmsnorm(jp["ln2"], x, jcfg.norm_eps),
                   jcfg.mlp_activation)
    blk = model.enc_layers[1]
    with torch.inference_mode():
        tx = t(ev)
        ty, _ = tattn.attn_prefill(blk.attn, cfg,
                                   trmsnorm(blk.ln1.scale, tx, cfg.norm_eps),
                                   t(np.asarray(pos), torch.long),
                                   causal=False)
        tx = tx + ty
        out = tx + tmlp(blk.mlp, trmsnorm(blk.ln2.scale, tx, cfg.norm_eps))
    close(exp, out)
    # one decoder block on token embeddings
    B, L = toks.shape
    h = np.random.default_rng(3).standard_normal(
        (B, L, jcfg.d_model)).astype(np.float32)
    dpos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L))
    for impl in IMPLS:
        exp, (jk, jv) = jencdec._dec_block(
            _layer(jparams["dec_super"], 0), jcfg, jnp.asarray(h),
            jnp.asarray(dpos), jck[0], jcv[0],
            "xla" if impl == "torch" else "pallas")
        with torch.inference_mode():
            out, (k, v) = tencdec._dec_block(
                model.dec_layers[0], cfg, t(h), t(dpos, torch.long), ck[0],
                cv[0], impl)
        close(exp, out)
        close(jk, k)
        close(jv, v)


# ---------------------------------------------------------------------------
# prefill, decode, forward
# ---------------------------------------------------------------------------

def _assert_cache_close(jcache, cache):
    """Every leaf: the reference's ``self.{k,v}`` against ``k``/``v``,
    ``cross_k``, ``cross_v``, and ``pos`` exactly."""
    assert set(cache) == {"k", "v", "cross_k", "cross_v", "pos"}
    close(jcache["self"]["k"], cache["k"])
    close(jcache["self"]["v"], cache["v"])
    close(jcache["cross_k"], cache["cross_k"])
    close(jcache["cross_v"], cache["cross_v"])
    np.testing.assert_array_equal(np.asarray(jcache["pos"]),
                                  cache["pos"].numpy())


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match(pair, impl):
    """``Model.prefill`` of 2 rows of 9 tokens with 8 evidence frames, then
    four ``decode_step``s feeding the reference's greedy tokens: logits,
    hidden states and every cache leaf after each call; decode writes
    the cache tensors in place (a captured step keeps its addresses)."""
    jcfg, jmodel, jparams, model = pair
    toks, ev = _inputs(jcfg, 2, 9, 4)
    jcache = jmodel.make_cache(2, 24)
    cache = model.make_cache(2, 24)
    jl, jh, jcache = jmodel.prefill(jparams, jnp.asarray(toks), jcache,
                                    jnp.asarray(ev), impl="xla")
    with torch.inference_mode():
        lg, h, cache = model.prefill(t(toks, torch.long), cache, t(ev),
                                     impl=impl)
    close(jl, lg)
    close(jh, h)
    _assert_cache_close(jcache, cache)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    tok = np.asarray(jnp.argmax(jl, -1))
    for _ in range(4):
        jl, jh, jcache = jmodel.decode_step(jparams, jnp.asarray(tok),
                                            jcache)
        with torch.inference_mode():
            lg, h, cache = model.decode_step(t(tok, torch.long), cache,
                                             impl=impl)
        close(jl, lg)
        close(jh, h)
        _assert_cache_close(jcache, cache)
        assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
        tok = np.asarray(jnp.argmax(jl, -1))


def test_forward_and_grads_match(pair):
    """``Model.forward`` (every position's logits and hidden states, no
    aux) and the gradients of a weighted sum of its logits with respect
    to every parameter, against ``encdec_forward`` and ``jax.grad``; with
    ``remat`` the same gradients. Parameters the loss does not reach get
    zero gradients in both."""
    jcfg, jmodel, jparams, model = pair
    toks, ev = _inputs(jcfg, 2, 6, 5)
    w = np.random.default_rng(6).standard_normal(
        (2, 6, jcfg.vocab_size)).astype(np.float32)

    def jloss(p):
        lg, _, _ = jmodel.forward(p, jnp.asarray(toks), jnp.asarray(ev))
        return jnp.sum(lg * w) / w.size

    jl, jh, jaux = jmodel.forward(jparams, jnp.asarray(toks),
                                  jnp.asarray(ev))
    with torch.inference_mode():
        lg, h, aux = model(t(toks, torch.long), t(ev))
    close(jl, lg)
    close(jh, h)
    assert jaux == aux == {}
    jg = params_from_jax(jax.tree.map(np.asarray, jax.grad(jloss)(jparams)),
                         model.cfg)
    params = dict(model.named_parameters())
    for remat in (False, True):
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        try:
            lg, _, _ = model(t(toks, torch.long), t(ev), remat=remat)
            (lg * t(w)).sum().div(w.size).backward()
        finally:
            for p in params.values():
                p.requires_grad_(False)
        assert set(jg) == set(params)
        for key, g in jg.items():
            got = params[key].grad
            got = torch.zeros_like(params[key]) if got is None else got
            np.testing.assert_allclose(g.numpy(), got.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=key)


# ---------------------------------------------------------------------------
# serving engine against the JAX engine
# ---------------------------------------------------------------------------

def _prompts(cfg, n, seed):
    """``n`` requests: prompts of 5 or 9 tokens (the reference engine
    compiles a prefill for each length) with seeded evidence frames."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.integers(2, cfg.vocab_size, size=(5, 9)[i % 2]).astype(
            np.int32)
        ev = rng.standard_normal((cfg.num_evidence_tokens,
                                  cfg.evidence_dim)).astype(np.float32)
        out.append((p, ev))
    return out


def _kw(cfg, mode, slots, K, xmodal):
    return dict(slots=slots, cache_len=32, mode=mode,
                max_new_tokens=MAX_NEW, eos_id=cfg.vocab_size, seed=0,
                macro_steps=K, xmodal_rescore=xmodal)


def _reference(pair, mode, slots, n, seed, xmodal=False):
    jcfg, jmodel, jparams, _ = pair
    eng = JEngine(jmodel, jparams, impl="xla",
                  sampling=JSampling(max_new_tokens=MAX_NEW,
                                     temperature=0.8),
                  camd=JCAMD(**CAMD), **_kw(jcfg, mode, slots, 4, xmodal))
    for i, (p, ev) in enumerate(_prompts(jcfg, n, seed)):
        eng.submit(JRequest(uid=i, prompt=p, evidence=ev))
    res = sorted(eng.run(), key=lambda r: r.uid)
    return res, eng


@pytest.fixture(scope="session")
def ref_greedy(pair):
    return _reference(pair, "greedy", 4, 5, 0)


@pytest.fixture(scope="session")
def ref_camd(pair):
    return {x: _reference(pair, "camd", 4, 5, 3, xmodal=x)
            for x in (False, True)}


def _port(pair, mode, slots, n, seed, K, impl, xmodal=False, noise=None):
    jcfg, _, _, model = pair
    eng = ServeEngine(model, impl=impl,
                      sampling=tconfig.SamplingConfig(
                          max_new_tokens=MAX_NEW, temperature=0.8),
                      camd=tconfig.CAMDConfig(**CAMD), noise=noise,
                      **_kw(jcfg, mode, slots, K, xmodal))
    for i, (p, ev) in enumerate(_prompts(jcfg, n, seed)):
        eng.submit(Request(uid=i, prompt=p, evidence=ev))
    with torch.inference_mode():
        res = sorted(eng.run(), key=lambda r: r.uid)
    return res, eng


def _counts(eng):
    return (eng.total_steps, eng.macro_launches, eng.host_syncs,
            eng.prefill_calls, eng.prefill_tokens)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("K", [4, 0])
def test_greedy_streams_equal_reference(pair, ref_greedy, impl, K):
    """Greedy streams at K 4 and on the per-token loop (K 0) against the
    reference engine's at K 4, token for token; at K 4 also its steps,
    launches, host syncs, and prefill calls and tokens (prompts only: the
    evidence feeds the encoder)."""
    exp, jeng = ref_greedy
    out, eng = _port(pair, "greedy", 4, 5, 0, K, impl)
    assert len(out) == len(exp) == 5
    for a, b in zip(exp, out):
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
        assert len(b.tokens) == MAX_NEW        # eos outside the vocab
    assert (eng.prefill_calls, eng.prefill_tokens) == (5, 5 * 5 + 2 * 4)
    if K == 4:
        assert _counts(eng) == _counts(jeng)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("xmodal", [False, True])
def test_camd_equals_reference(pair, ref_camd, impl, xmodal):
    """CAMD on 4 slots and 5 requests with the reference's noise, with and
    without cross-modal rescoring: rounds, candidates, tokens spent and
    streams equal, cluster ids equal, p*, each candidate's score and
    alignment terms within 1e-4, the requests' alignment constants and
    evidence entropies too, and the engine's counts equal."""
    exp, jeng = ref_camd[xmodal]
    out, eng = _port(pair, "camd", 4, 5, 3, 4, impl, xmodal=xmodal,
                     noise=ReferenceNoise(0))
    assert len(out) == len(exp) == 5
    for a, b in zip(exp, out):
        assert (a.n_candidates, a.rounds, a.tokens_spent,
                a.stopped_early) == (b.n_candidates, b.rounds,
                                     b.tokens_spent, b.stopped_early)
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
        np.testing.assert_allclose(a.p_star, b.p_star, **TOL)
        for ca, cb in zip(a.candidates, b.candidates):
            assert ca["tokens"].tolist() == cb["tokens"].tolist()
            assert ca["cluster"] == cb["cluster"]
            assert ("s_align_xmodal" in ca) == ("s_align_xmodal" in cb) \
                == xmodal
            for key in ("align", "score", "s_align_xmodal"):
                if key in ca:
                    np.testing.assert_allclose(ca[key], cb[key], **TOL)
        ia, ib = jeng._reqs[a.uid], eng._reqs[b.uid]
        for key in ("align_const", "evidence_entropy"):
            np.testing.assert_allclose(ia[key], ib[key], **TOL)
    assert sum(r.rounds for r in out) > len(out)      # some went again
    assert _counts(eng) == _counts(jeng)


def test_paged_impls_and_decoder_only_paths_refused(pair):
    """No layer to page: the paged impls raise, as the reference's, and so
    do the paged cache, continuation and chunked prefill, speculative
    blocks, a prefill without evidence, and speculation in the engine.
    ``capabilities()`` equals the reference's."""
    jcfg, jmodel, _, model = pair
    for impl in ("paged", "paged_cuda"):
        with pytest.raises(ValueError, match="pageable"):
            ServeEngine(model, slots=2, cache_len=32, impl=impl)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        model.make_paged_cache(2, 32, page_size=8, num_pages=9)
    toks = torch.zeros((1, 4), dtype=torch.long)
    cache = model.make_cache(1, 32)
    for call in (lambda: model.prefill_suffix(toks, cache, {}, 4),
                 lambda: model.prefill_chunked(toks, cache, 2),
                 lambda: model.decode_block(toks, cache),
                 lambda: model.prefill(toks, cache),
                 lambda: model(toks)):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(ValueError, match="speculative"):
        ServeEngine(model, slots=2, cache_len=32, spec_k=4)
    assert model.capabilities() == jmodel.capabilities()
    assert model.state_kind == "kv" and not model.has_pageable_layers
