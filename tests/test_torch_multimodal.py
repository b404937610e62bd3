"""The port's multimodal serving path against the JAX package's, on the CPU.

The reduced llava-1.5-7b (2 layers, d 256, 8 image tokens from a 2-layer
d-64 tower) with the reference's weights carried over by
``params_from_jax`` serves the same seeded images and prompts in both
packages. Tolerances, all fp32: vision encode 1e-4 abs + 1e-4 rel (two
tower layers of fp32 matrix products in another summation order);
prefill logits and hidden states 1e-4; the plain cross-modal score
against the reference's Pallas kernel (interpret mode) and oracle 1e-5;
per-candidate scores and alignment terms 1e-4. Token streams, candidate
and round counts, and the image-memo counters must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CAMDConfig as JCAMD
from repro.config import PagedKVConfig as JPaged
from repro.config import SamplingConfig as JSampling
from repro.configs import get_config as jget_config
from repro.core import scoring as jscoring
from repro.kernels import ref as jref
from repro.kernels.xmodal_score import xmodal_score as pallas_xmodal
from repro.models import build_model as jbuild
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JEngine
from repro_torch import config as tconfig
from repro_torch.convert import params_from_jax
from repro_torch.core import scoring as tscoring
from repro_torch.kernels import ops
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServeEngine
from torch_ranks import _one_torch_thread  # noqa: F401

ENC_TOL = dict(rtol=1e-4, atol=1e-4)
XM_TOL = dict(rtol=1e-5, atol=1e-5)


def port_cfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(tconfig.ModelConfig)}
    kw["vision"] = tconfig.VisionConfig(**dataclasses.asdict(jcfg.vision))
    return tconfig.ModelConfig(**kw)


def _pair(**overrides):
    jcfg = jget_config("llava_1_5_7b").reduced().with_overrides(
        dtype="float32", **overrides)
    jmodel = jbuild(jcfg, jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    model = build_model(cfg, torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg))
    return jcfg, jmodel, jparams, model


@pytest.fixture(scope="module")
def llava():
    """The reduced llava: evidence_dim == d_model, no evidence_proj."""
    return _pair()


@pytest.fixture(scope="module")
def llava_proj():
    """The reduced llava with 128-wide evidence through evidence_proj."""
    return _pair(evidence_dim=128)


def _images(cfg, n, seed):
    v = cfg.vision
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, v.image_h, v.image_w,
                                v.channels)).astype(np.float32)


def close(exp, out, tol):
    np.testing.assert_allclose(np.asarray(exp, np.float32),
                               out.float().numpy(), **tol)


# ---------------------------------------------------------------------------
# config, vision tower, prefill
# ---------------------------------------------------------------------------

def test_reduced_llava_config_matches_reference(llava):
    from repro_torch.configs import get_config
    jcfg = jget_config("llava_1_5_7b")
    cfg = get_config("llava-1.5-7b")
    assert cfg is get_config("llava_1_5_7b")
    assert dataclasses.asdict(cfg.vision) == dataclasses.asdict(jcfg.vision)
    assert cfg.vision.n_patches == cfg.num_evidence_tokens == 576
    red, jred = cfg.reduced(), jcfg.reduced()
    for f in dataclasses.fields(tconfig.ModelConfig):
        if f.name != "vision":
            assert getattr(red, f.name) == getattr(jred, f.name), f.name
    assert dataclasses.asdict(red.vision) == dataclasses.asdict(jred.vision)
    model = llava[3]
    assert model.has_vision_tower and model.num_evidence_tokens == 8
    assert model.evidence_proj is None


@pytest.mark.parametrize("variant", ["llava", "llava_proj"])
def test_vision_encode_matches_reference(variant, request):
    jcfg, jmodel, jparams, model = request.getfixturevalue(variant)
    imgs = _images(jcfg, 2, seed=4)
    exp = jmodel.encode_image(jparams, jnp.asarray(imgs))
    with torch.inference_mode():
        out = model.encode_image(torch.from_numpy(imgs))
    assert out.shape == (2, jcfg.num_evidence_tokens,
                         jcfg.evidence_dim or jcfg.d_model)
    close(exp, out, ENC_TOL)
    assert (model.evidence_proj is None) == (variant == "llava")


@pytest.mark.parametrize("variant", ["llava", "llava_proj"])
@pytest.mark.parametrize("impl,ref_impl", [("torch", "xla"),
                                           ("cuda", "pallas")])
def test_evidence_prefill_matches_reference(variant, impl, ref_impl,
                                            request):
    """Bucketed prefill of right-padded prompts behind their evidence
    rows (lengths count the evidence), and the one-row unbucketed path."""
    jcfg, jmodel, jparams, model = request.getfixturevalue(variant)
    ne, De = jcfg.num_evidence_tokens, jcfg.evidence_dim
    rng = np.random.default_rng(5)
    Lb, plens = 16, (5, 16, 9, 1)
    toks = rng.integers(2, jcfg.vocab_size, (4, Lb)).astype(np.int32)
    ev = rng.standard_normal((4, ne, De)).astype(np.float32)
    lens = np.asarray(plens, np.int32) + ne
    cache_len = 32
    jl, jh, jc = jmodel.prefill(jparams, jnp.asarray(toks),
                                jmodel.make_cache(4, cache_len),
                                jnp.asarray(ev), impl=ref_impl,
                                lengths=jnp.asarray(lens))
    with torch.inference_mode():
        tl, th, tc = model.prefill(
            torch.from_numpy(toks).long(), model.make_cache(4, cache_len),
            torch.from_numpy(ev), impl=impl,
            lengths=torch.from_numpy(lens))
    close(jl, tl, ENC_TOL)
    close(jh, th, ENC_TOL)
    np.testing.assert_array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())
    for i, n in enumerate(lens):       # the real rows of every layer's K/V
        close(jc["super"][0]["k"][:, i, :n], tc["k"][:, i, :n], ENC_TOL)
    jl1, jh1, _ = jmodel.prefill(jparams, jnp.asarray(toks[:1, :5]),
                                 jmodel.make_cache(1, cache_len),
                                 jnp.asarray(ev[:1]), impl=ref_impl)
    with torch.inference_mode():
        tl1, th1, _ = model.prefill(
            torch.from_numpy(toks[:1, :5]).long(),
            model.make_cache(1, cache_len), torch.from_numpy(ev[:1]),
            impl=impl)
    close(jl1, tl1, ENC_TOL)
    close(jh1, th1, ENC_TOL)
    close(jl1, tl[:1], ENC_TOL)        # bucketing changes nothing


# ---------------------------------------------------------------------------
# the cross-modal score (K4's plain version)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,Nv,Nt", [(1, 7, 129), (7, 129, 1),
                                     (129, 1, 7)])
def test_xmodal_plain_matches_reference(L, Nv, Nt):
    B, d = 3, 48
    rng = np.random.default_rng(L * 1000 + Nv)
    tok = rng.standard_normal((B, L, d)).astype(np.float32)
    vis = rng.standard_normal((B, Nv, d)).astype(np.float32)
    txt = rng.standard_normal((B, Nt, d)).astype(np.float32)
    mask = (rng.random((B, L)) < 0.6).astype(np.float32)
    mask[1] = 0.0                            # a row with no live token
    vis[2, 0] = 0.0                          # a zero row: |x| < eps
    args = [jnp.asarray(a) for a in (tok, mask, vis, txt)]
    exp_kernel = pallas_xmodal(*args, interpret=True)
    exp_oracle = jref.xmodal_score_ref(*args)
    out = ops.xmodal_score(*(torch.from_numpy(a)
                             for a in (tok, mask, vis, txt)))
    assert out.shape == (B,) and out.dtype == torch.float32
    close(exp_kernel, out, XM_TOL)
    close(exp_oracle, out, XM_TOL)
    # the two sums the card's wrapper combines (K4a's and K4b's)
    t = torch.from_numpy
    sum1 = ops.xmodal_mean_sum(t(tok), t(mask), t(vis))
    sum2 = ops.xmodal_max_sum(t(txt), t(vis))
    n_tok = np.maximum(mask.sum(-1), 1.0)
    close(exp_kernel, 0.5 * (sum1 / t(n_tok * Nv) + sum2 / Nt), XM_TOL)


def test_cross_modal_and_weighted_score_match_reference():
    rng = np.random.default_rng(11)
    B, L, Nv, Nt, d = 2, 6, 5, 4, 32
    lp = rng.standard_normal((B, L)).astype(np.float32)
    mask = np.ones((B, L), np.float32)
    mask[0, 4:] = 0.0
    hid, tok = (rng.standard_normal((B, L, d)).astype(np.float32)
                for _ in range(2))
    vis = rng.standard_normal((B, Nv, d)).astype(np.float32)
    txt = rng.standard_normal((B, Nt, d)).astype(np.float32)
    t = torch.from_numpy
    close(jscoring.cross_modal_consistency(tok, mask, vis, txt),
          tscoring.cross_modal_consistency(t(tok), t(mask), t(vis), t(txt)),
          XM_TOL)
    # unbatched visual evidence broadcasts over the candidates
    close(jscoring.cross_modal_consistency(tok, mask, vis[0], txt[0]),
          tscoring.cross_modal_consistency(t(tok), t(mask), t(vis[0]),
                                           t(txt[0])), XM_TOL)
    for impl in ("torch", "cuda"):
        close(jscoring.evidence_weighted_score(
                  lp, mask, hidden=hid, token_embs=tok, visual_feats=vis,
                  text_feats=txt, impl="pallas" if impl == "cuda" else "xla"),
              tscoring.evidence_weighted_score(
                  t(lp), t(mask), hidden=t(hid), token_embs=t(tok),
                  visual_feats=t(vis), text_feats=t(txt), impl=impl),
              ENC_TOL)


# ---------------------------------------------------------------------------
# image serving: greedy and injected-noise CAMD streams
# ---------------------------------------------------------------------------

class ReferenceNoise:
    """The reference engine's Gumbel draws, as the port's noise source
    (as in ``tests/test_torch_engine_camd.py``)."""

    def __init__(self, seed: int, legacy: bool = False):
        self.key = jax.random.PRNGKey(seed)
        self.decode_key = jax.random.fold_in(jax.random.PRNGKey(seed),
                                             0x6d6163)
        self.legacy = legacy

    @staticmethod
    def _gumbel(key, shape):
        return torch.from_numpy(np.array(jax.random.gumbel(key, shape,
                                                           jnp.float32)))

    def first(self, n, vocab):
        self.key, *keys = jax.random.split(self.key, n + 1)
        return torch.cat([self._gumbel(k, (1, vocab)) for k in keys])

    def step(self, t, batch, vocab):
        if self.legacy:
            self.key, k = jax.random.split(self.key)
        else:
            k = jax.random.fold_in(self.decode_key, t)
        return self._gumbel(k, (batch, vocab))


CAMD = dict(samples_per_round=2, max_rounds=3, min_samples=2, max_clusters=8)


def _requests(cfg, req_cls):
    """Five requests over two images, one of them text-only, with prompts
    in two buckets."""
    rng = np.random.default_rng(2)
    imgs = _images(cfg, 2, seed=3)
    out = []
    for i, (n, img) in enumerate(((6, 0), (9, 1), (6, 0), (20, None),
                                  (3, 0))):
        p = rng.integers(2, cfg.vocab_size, n).astype(np.int32)
        out.append(req_cls(uid=i, prompt=p,
                           image=None if img is None else imgs[img]))
    return out


def _serve(jmodel, jparams, jcfg, model, *, ref_impl, impl, mode, K=8,
           sched="fifo", xmodal=False):
    kw = dict(slots=6, cache_len=64, mode=mode, n_candidates=3,
              max_new_tokens=8, eos_id=jcfg.vocab_size, seed=0,
              macro_steps=K, sched_policy=sched, xmodal_rescore=xmodal)
    jeng = JEngine(jmodel, jparams, impl=ref_impl,
                   paged_kv=JPaged(page_size=8),
                   sampling=JSampling(max_new_tokens=8, temperature=0.8),
                   camd=JCAMD(**CAMD), **kw)
    for r in _requests(jcfg, JRequest):
        jeng.submit(r)
    exp = sorted(jeng.run(), key=lambda r: r.uid)
    eng = ServeEngine(model, impl=impl,
                      paged_kv=tconfig.PagedKVConfig(page_size=8),
                      sampling=tconfig.SamplingConfig(max_new_tokens=8,
                                                      temperature=0.8),
                      camd=tconfig.CAMDConfig(**CAMD),
                      noise=ReferenceNoise(0, legacy=K == 0), **kw)
    for r in _requests(jcfg, Request):
        eng.submit(r)
    with torch.inference_mode():
        out = sorted(eng.run(), key=lambda r: r.uid)
    assert len(out) == len(exp) == 5
    tol = dict(rtol=1e-4, atol=1e-4)
    for a, b in zip(exp, out):
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
        assert (a.n_candidates, a.rounds, a.tokens_spent) == \
            (b.n_candidates, b.rounds, b.tokens_spent)
        np.testing.assert_allclose(a.p_star, b.p_star, **tol)
        for ca, cb in zip(a.candidates, b.candidates):
            assert ca["tokens"].tolist() == cb["tokens"].tolist()
            assert ca["cluster"] == cb["cluster"]
            assert ("s_align_xmodal" in ca) == ("s_align_xmodal" in cb)
            for key in ("align", "score", "s_align_xmodal"):
                if key in ca:
                    np.testing.assert_allclose(ca[key], cb[key], **tol)
        ia, ib = jeng._reqs[a.uid], eng._reqs[b.uid]
        for key in ("align_const", "evidence_entropy"):
            assert (key in ia) == (key in ib)
            if key in ia:
                np.testing.assert_allclose(ia[key], ib[key], **tol)
    assert (eng.image_encodes, eng.image_feat_hits) == \
        (jeng.image_encodes, jeng.image_feat_hits) == (2, 2)
    assert (eng.total_steps, eng.macro_launches, eng.host_syncs,
            eng.prefill_calls, eng.prefill_tokens) == \
        (jeng.total_steps, jeng.macro_launches, jeng.host_syncs,
         jeng.prefill_calls, jeng.prefill_tokens)
    if eng.paged:
        eng.pool.check()
        assert eng.pool.in_use == 0 and eng._reserved == 0
    return exp, out, jeng, eng


@pytest.mark.parametrize("ref_impl,impl,K", [("xla", "torch", 8),
                                             ("paged", "paged", 0)])
def test_greedy_image_streams_equal_reference(llava, ref_impl, impl, K):
    """Greedy streams, macro-step and per-token loops; the candidates'
    alignment aggregates agree too, so every launch saw its slots'
    evidence rows."""
    jcfg, jmodel, jparams, model = llava
    _, out, _, _ = _serve(jmodel, jparams, jcfg, model, ref_impl=ref_impl,
                          impl=impl, mode="greedy", K=K)
    assert all(len(r.tokens) == 8 for r in out)   # eos outside the vocab


def test_camd_xmodal_streams_equal_reference(llava):
    """Injected reference noise, the paged kernel impl and the coverage
    scheduler (which ranks new requests by their evidence entropy): CAMD
    streams, rounds and p* equal, and each candidate's rescored S_align
    within 1e-4 (checked in _serve)."""
    jcfg, jmodel, jparams, model = llava
    _, out, _, _ = _serve(jmodel, jparams, jcfg, model, ref_impl="paged",
                          impl="paged_cuda", mode="camd", sched="coverage",
                          xmodal=True)
    assert all("s_align_xmodal" in c for r in out if r.uid != 3
               for c in r.candidates)
    assert "s_align_xmodal" not in out[3].candidates[0]   # text-only
    assert sum(r.rounds for r in out) > len(out)      # some went again


def test_image_memo_and_misuse(llava):
    jcfg, _, _, model = llava
    eng = ServeEngine(model, cache_len=64, mode="greedy", max_new_tokens=4)
    imgs = _images(jcfg, 1, seed=9)
    for uid in range(3):
        eng.submit(Request(uid=uid, prompt=np.arange(2, 6, dtype=np.int32),
                           image=imgs[0]))
    assert (eng.image_encodes, eng.image_feat_hits) == (1, 2)
    assert eng.sched_stats()["image_encodes"] == 1
    with pytest.raises(ValueError, match="evidence of shape"):
        eng.submit(Request(uid=9, prompt=np.arange(2, 6, dtype=np.int32),
                           evidence=np.zeros((3, 5), np.float32)))
