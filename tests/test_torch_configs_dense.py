"""The port's remaining attention-only configs against the JAX package's,
on the CPU: internvl2-2b, qwen2.5-32b, yi-34b and granite-34b.

Each config equals the reference's field for field and builds. At
``reduced()`` size, with the reference's weights carried over by
``params_from_jax`` and inputs made by numpy from a seed, fp32 prefill
logits and four decode steps agree within 1e-4 abs + 1e-4 rel (the same
products in another summation order); the paged engines' greedy streams
are equal token for token; internvl2-2b's CAMD p* and rescored S_align
agree within 1e-4 with images (the reference's noise injected). A granite
variant with 48 query heads over one kv head runs the whole engine at
G 48, the decode kernel's plain version on the CPU. One bf16 case compares
logits within 2e-2 of their largest magnitude: bf16 products round their
fp32 sums at other places in the two frameworks, one or two bf16 ulps of
a hidden state apart, which leaves a few logits in a thousand 0.025-0.04
from the reference's (each package as far from the same weights run in
fp32 as the other), beyond 2e-2 abs + 2e-2 rel where a logit is near 0.
bf16 greedy streams may part on near-ties, so they are not compared.
The decode kernels' plain versions are held against ``repro.kernels.ref``
at G 5, 7, 12 and 48 within 2e-5.
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
from repro.kernels import ref as jref
from repro.models import build_model as jbuild
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JEngine
from repro_torch import config as tconfig
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServeEngine
from test_torch_engine_camd import ReferenceNoise
from torch_ranks import _one_torch_thread  # noqa: F401

NEW = {"internvl2_2b": "internvl2-2b", "qwen2_5_32b": "qwen2.5-32b",
       "yi_34b": "yi-34b", "granite_34b": "granite-34b"}
TOL = dict(rtol=1e-4, atol=1e-4)
CAMD = dict(samples_per_round=2, max_rounds=3, min_samples=2, max_clusters=8)


def port_cfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(tconfig.ModelConfig)}
    if jcfg.vision is not None:
        kw["vision"] = tconfig.VisionConfig(**dataclasses.asdict(jcfg.vision))
    return tconfig.ModelConfig(**kw)


def make_pair(jcfg, dtype=jnp.float32):
    """The reference model and params (seed 0) in ``dtype``, and the port's
    model with those params."""
    jmodel = jbuild(jcfg, dtype)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    model = build_model(cfg, torch.float32 if dtype == jnp.float32
                        else torch.bfloat16, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg))
    return jmodel, jparams, model


@pytest.fixture(scope="module")
def reduced_pair():
    """name -> (jcfg, jmodel, jparams, port model) of a new config at
    reduced() size in fp32, each made once a module."""
    made = {}

    def get(name):
        if name not in made:
            jcfg = jget_config(name).reduced().with_overrides(
                dtype="float32")
            made[name] = (jcfg,) + make_pair(jcfg)
        return made[name]
    return get


def close(exp, out, tol=TOL):
    np.testing.assert_allclose(np.asarray(exp, np.float32),
                               out.detach().float().numpy(), **tol)


def close_bf16(exp, out):
    """max |out - exp| within 2e-2 of max |exp|."""
    exp = np.asarray(exp, np.float32)
    err = np.abs(out.float().numpy() - exp).max()
    assert err <= 2e-2 * np.abs(exp).max(), (err, np.abs(exp).max())


def _images(cfg, n, seed):
    v = cfg.vision
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, v.image_h, v.image_w,
                                v.channels)).astype(np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module,name", list(NEW.items()))
def test_config_equals_reference(module, name):
    """Field for field the reference's, under both spellings, with the
    reference's parameter count; the full config's fp32 weights of the
    three large ones exceed an 80 GB card, their bf16 weights do not."""
    cfg = get_config(name)
    assert get_config(module) is cfg and name in list_configs()
    jcfg = jget_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert cfg.num_params() == jcfg.num_params()
    assert cfg.reduced().num_params() == jcfg.reduced().num_params()
    if name != "internvl2-2b":
        assert 4 * cfg.num_params() > 80e9 > 2 * cfg.num_params()
    build_model(cfg.reduced(), device="cpu")


def test_served_configs_cover_the_attention_only_ones():
    """Every attention-only config of the reference is registered, but
    kimi-k2-1t-a32b (about 1T parameters: no single card holds it); the
    recurrent and hybrid ones are registered beside them
    (tests/test_torch_recurrent_models.py), and the encoder-decoder
    seamless-m4t-large-v2 (tests/test_torch_encdec.py)."""
    from repro.configs import list_configs as jlist
    attn_only = {n for n in jlist()
                 if all(k == "attn" for k in jget_config(n).layer_kinds)
                 and not jget_config(n).is_encoder_decoder}
    assert set(list_configs()) == attn_only - {"kimi-k2-1t-a32b"} | {
        "mamba2-780m", "recurrentgemma-2b", "seamless-m4t-large-v2"}
    assert jget_config("seamless-m4t-large-v2").is_encoder_decoder
    assert jget_config("kimi-k2-1t-a32b").num_params() * 2 > 1e12


# ---------------------------------------------------------------------------
# model: prefill and decode logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(NEW.values()))
def test_reduced_prefill_and_decode_match(reduced_pair, name):
    """Prefill logits and hidden states, then four decode steps on the
    dense cache, through the kernel impls (their plain versions on the
    CPU) against the reference's Pallas impl; internvl2-2b first encodes
    two images and prefills their evidence rows ahead of the prompt."""
    jcfg, jmodel, jparams, model = reduced_pair(name)
    rng = np.random.default_rng(1)
    B, L, S = 2, 11, 48
    toks = rng.integers(2, jcfg.vocab_size, (B, L)).astype(np.int32)
    jev = tev = None
    if jcfg.vision is not None:
        img = _images(jcfg, B, seed=2)
        jev = jmodel.encode_image(jparams, jnp.asarray(img))
        with torch.inference_mode():
            tev = model.encode_image(torch.from_numpy(img))
        close(jev, tev)
    jl, jh, jc = jmodel.prefill(jparams, jnp.asarray(toks),
                                jmodel.make_cache(B, S), jev,
                                impl="pallas")
    with torch.inference_mode():
        tl, th, tc = model.prefill(torch.from_numpy(toks).long(),
                                   model.make_cache(B, S), tev, impl="cuda")
    close(jl, tl)
    close(jh, th)
    for step in range(4):
        tok = rng.integers(2, jcfg.vocab_size, B).astype(np.int32)
        jl, _, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                       impl="pallas")
        with torch.inference_mode():
            tl, _, tc = model.decode_step(torch.from_numpy(tok).long(), tc,
                                          impl="cuda")
        close(jl, tl)


def test_bf16_logits_match_reference():
    """Reduced qwen2.5-32b (qkv biases, rope theta 1e6) in bf16: prefill
    and two decode steps' logits within 2e-2 of their scale, each from its
    own package's bf16 cache."""
    jcfg = jget_config("qwen2.5-32b").reduced()
    jmodel, jparams, model = make_pair(jcfg, jnp.bfloat16)
    assert model.layers[0].attn.wq.bias.dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    toks = rng.integers(2, jcfg.vocab_size, (2, 9)).astype(np.int32)
    jl, _, jc = jmodel.prefill(jparams, jnp.asarray(toks),
                               jmodel.make_cache(2, 32))
    with torch.inference_mode():
        tl, _, tc = model.prefill(torch.from_numpy(toks).long(),
                                  model.make_cache(2, 32))
    assert tl.dtype == torch.bfloat16
    close_bf16(jl, tl)
    for _ in range(2):
        tok = rng.integers(2, jcfg.vocab_size, 2).astype(np.int32)
        jl, _, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc)
        with torch.inference_mode():
            tl, _, tc = model.decode_step(torch.from_numpy(tok).long(), tc)
        close_bf16(jl, tl)


# ---------------------------------------------------------------------------
# serving engines
# ---------------------------------------------------------------------------

def _requests(cfg, req_cls, images):
    """Four requests in two prompt buckets; with ``images``, three of them
    carry one of two images."""
    rng = np.random.default_rng(5)
    imgs = _images(cfg, 2, seed=6) if images else None
    out = []
    for i, (n, im) in enumerate(((6, 0), (9, 1), (20, None), (4, 0))):
        p = rng.integers(2, cfg.vocab_size, n).astype(np.int32)
        out.append(req_cls(uid=i, prompt=p, image=None if imgs is None or
                           im is None else imgs[im]))
    return out


def serve_both(jcfg, jmodel, jparams, model, *, ref_impl, impl, mode,
               images=False, xmodal=False):
    """The same requests through the reference's and the port's engine
    (8 new tokens, eos outside the vocab, macro-steps of 8); returns both
    engines' results by uid, after checking streams, counts and steps."""
    kw = dict(slots=6, cache_len=64, mode=mode, n_candidates=3,
              max_new_tokens=8, eos_id=jcfg.vocab_size, seed=0,
              macro_steps=8, xmodal_rescore=xmodal)
    jeng = JEngine(jmodel, jparams, impl=ref_impl,
                   paged_kv=JPaged(page_size=8),
                   sampling=JSampling(max_new_tokens=8, temperature=0.8),
                   camd=JCAMD(**CAMD), **kw)
    for r in _requests(jcfg, JRequest, images):
        jeng.submit(r)
    exp = sorted(jeng.run(), key=lambda r: r.uid)
    eng = ServeEngine(model, impl=impl,
                      paged_kv=tconfig.PagedKVConfig(page_size=8),
                      sampling=tconfig.SamplingConfig(max_new_tokens=8,
                                                      temperature=0.8),
                      camd=tconfig.CAMDConfig(**CAMD),
                      noise=ReferenceNoise(0), **kw)
    for r in _requests(jcfg, Request, images):
        eng.submit(r)
    with torch.inference_mode():
        out = sorted(eng.run(), key=lambda r: r.uid)
    assert len(out) == len(exp) == 4
    for a, b in zip(exp, out):
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
        assert (a.n_candidates, a.rounds, a.tokens_spent) == \
            (b.n_candidates, b.rounds, b.tokens_spent)
        assert [c["tokens"].tolist() for c in a.candidates] == \
            [c["tokens"].tolist() for c in b.candidates]
    assert (eng.total_steps, eng.macro_launches, eng.host_syncs) == \
        (jeng.total_steps, jeng.macro_launches, jeng.host_syncs)
    eng.pool.check()
    assert eng.pool.in_use == 0 and eng._reserved == 0
    return exp, out, eng


@pytest.mark.parametrize("name", list(NEW.values()))
def test_paged_greedy_streams_equal_reference(reduced_pair, name):
    jcfg, jmodel, jparams, model = reduced_pair(name)
    _, out, _ = serve_both(jcfg, jmodel, jparams, model, ref_impl="paged",
                           impl="paged", mode="greedy",
                           images=jcfg.vision is not None)
    assert all(len(r.tokens) == 8 for r in out)   # eos outside the vocab


def test_internvl2_camd_with_images_equals_reference(reduced_pair):
    """CAMD with the reference's noise on image requests through the
    paged kernel impl, candidates rescored by the cross-modal score:
    streams and rounds equal, p* and every candidate's S_align, score and
    rescored S_align within 1e-4."""
    jcfg, jmodel, jparams, model = reduced_pair("internvl2-2b")
    assert model.evidence_proj is None      # evidence_dim == d_model
    exp, out, eng = serve_both(jcfg, jmodel, jparams, model,
                               ref_impl="paged", impl="paged_cuda",
                               mode="camd", images=True, xmodal=True)
    for a, b in zip(exp, out):
        np.testing.assert_allclose(a.p_star, b.p_star, **TOL)
        for ca, cb in zip(a.candidates, b.candidates):
            assert ("s_align_xmodal" in ca) == ("s_align_xmodal" in cb)
            for key in ("align", "score", "s_align_xmodal"):
                if key in ca:
                    np.testing.assert_allclose(ca[key], cb[key], **TOL)
    assert sum("s_align_xmodal" in c for r in out for c in r.candidates) > 0
    assert eng.image_encodes == 2


def test_g48_engine_equals_reference():
    """granite-34b's head layout at CPU size: 48 query heads over one kv
    head (head_dim 16), gelu MLP, tied embeddings; greedy streams of the
    kernel impl (the decode kernel's plain version on the CPU) against the
    reference's Pallas paged impl."""
    jcfg = jget_config("granite-34b").reduced().with_overrides(
        num_heads=48, num_kv_heads=1, head_dim=16, dtype="float32")
    jmodel, jparams, model = make_pair(jcfg)
    assert model.layers[0].attn.wq.kernel.shape == (256, 768)
    assert model.layers[0].mlp.activation == "gelu"
    _, out, _ = serve_both(jcfg, jmodel, jparams, model,
                           ref_impl="paged_pallas", impl="paged_cuda",
                           mode="greedy")
    assert all(len(r.tokens) == 8 for r in out)


# ---------------------------------------------------------------------------
# decode kernels at any G
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [5, 7, 12, 48])
@pytest.mark.parametrize("kernel", ["dense", "paged"])
def test_decode_plain_any_g_matches_reference(kernel, G):
    """K3's and K1's plain versions at qwen2.5-32b's (5), yi-34b's (7),
    a G that is not a multiple of 8 (12) and granite-34b's (48) query
    heads per kv head, against the reference's oracles."""
    rng = np.random.default_rng(G)
    B, Hkv, hd = 3, 2 if G < 48 else 1, 32
    H = G * Hkv
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    t = torch.from_numpy
    if kernel == "dense":
        S = 40
        k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
        v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
        mask = rng.random((B, S)) < 0.7
        mask[:, 0] = True
        exp = jref.decode_attention_ref(q, k, v, mask)
        out = ops.decode_attention(t(q), t(k), t(v), t(mask))
    else:
        ps, n = 8, 5
        P = B * n + 1
        kp = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
        vp = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
        bt = (1 + rng.permutation(P - 1)[:B * n]).reshape(B, n).astype(
            np.int32)
        ln = np.array([1, 21, n * ps], np.int32)
        exp = jref.paged_decode_attention_ref(q, kp, vp, bt, ln)
        out = ops.paged_decode_attention(t(q), t(kp), t(vp), t(bt), t(ln))
    np.testing.assert_allclose(np.asarray(exp), out.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("G,groups", [(1, 1), (5, 1), (8, 1), (12, 2),
                                      (48, 6), (10, 2), (11, 11), (9, 3)])
def test_decode_groups(G, groups):
    """The fewest groups of at most 8 query heads that divide G."""
    assert ops.decode_groups(G) == groups
    assert G % groups == 0 and G // groups <= ops.DEC_MAX_G


@pytest.mark.parametrize("kernel", ["dense", "paged"])
def test_wrappers_plan_head_groups(monkeypatch, kernel):
    """The card path of K3's and K1's wrappers at granite-34b's heads (48
    over one kv head), with tensors that claim to lie on the card but hold
    no data: the split plan counts the 6 head groups a batch row's split
    takes as blocks, and the workspace holds every query head's
    partials."""
    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    def empty(*shape, dtype=torch.float32):
        return torch.Tensor._make_subclass(
            OnCard, torch.empty(shape, dtype=dtype, device="meta"))

    launched, work = [], []
    monkeypatch.setattr(ops, "_sms", lambda t: 132)
    monkeypatch.setattr(ops, "_launch",
                        lambda name, *args: launched.append((name, args)))
    real = ops._split_workspace
    monkeypatch.setattr(ops, "_split_workspace", lambda *a: work.append(
        real(*a)) or work[-1])
    B, H, Hkv, hd, S = 8, 48, 1, 128, 4096
    q = empty(B, 1, H, hd, dtype=torch.bfloat16)
    if kernel == "dense":
        ops.decode_attention(q, empty(B, S, Hkv, hd, dtype=torch.bfloat16),
                             empty(B, S, Hkv, hd, dtype=torch.bfloat16),
                             empty(B, S, dtype=torch.bool))
        plan = launched[0][1][-3:-1]
    else:
        ps, n = 16, S // 16
        P = B * n + 1
        ops.paged_decode_attention(
            q, empty(P, ps, Hkv, hd, dtype=torch.bfloat16),
            empty(P, ps, Hkv, hd, dtype=torch.bfloat16),
            empty(B, n, dtype=torch.int32), empty(B, dtype=torch.int32))
        plan = launched[0][1][-4:-2]
    assert plan == ops.decode_splits(B, Hkv * 6, S, 132) == (43, 96)
    assert ops.decode_splits(B, Hkv, S, 132)[0] == 64
    assert work[0].shape == (B, Hkv, plan[0], H // Hkv, hd + 2)


# ---------------------------------------------------------------------------
# the serve CLI's memory check
# ---------------------------------------------------------------------------

def test_build_engine_refuses_weights_beyond_device_memory(monkeypatch):
    """Weights larger than the device's memory stop ``build_engine`` with
    their size before anything is allocated; the same config in bf16 on an
    80 GB card passes the check (the model build is stubbed out here)."""
    class Built(Exception):
        pass

    def no_build(*args, **kw):
        raise Built

    monkeypatch.setattr(serve, "device_memory_bytes", lambda dev: 80 * 10**9)
    monkeypatch.setattr(serve, "build_model", no_build)
    args = serve.parse_args(["--arch", "qwen2.5-32b", "--no-reduced",
                             "--device", "cpu"])
    with pytest.raises(SystemExit, match=r"131\.1 GB of torch\.float32"):
        serve.build_engine(args)
    with pytest.raises(Built):
        serve.build_engine(args, param_dtype=torch.bfloat16)
    monkeypatch.setattr(serve, "device_memory_bytes", lambda dev: 10**6)
    with pytest.raises(SystemExit, match="reduced"):
        serve.build_engine(serve.parse_args(["--device", "cpu"]))
    monkeypatch.setattr(serve, "device_memory_bytes", lambda dev: None)
    with pytest.raises(Built):      # the CPU is not checked
        serve.build_engine(args)
