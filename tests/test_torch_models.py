"""The PyTorch port's model stack against the JAX package, on the CPU.

Same inputs (numpy, from a seed) and the same weights (the reference's
params carried over by ``repro_torch.convert.params_from_jax``) go
through both; fp32 results must agree within atol/rtol 1e-5 (layers,
attention, hidden states) and 1e-4 (logits). Reference kernels run as
the JAX package runs them on the CPU (``impl="pallas"`` dispatches to its
plain reference there); the port's ``cuda`` impl runs its kernels' plain
versions on CPU tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch import config as tconfig
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.model import build_model
from torch_ranks import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def port_cfg(jcfg):
    return tconfig.ModelConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(
                                      tconfig.ModelConfig)})


def port_model(jcfg, jparams):
    cfg = port_cfg(jcfg)
    model = build_model(cfg, torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg))
    return model


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), **tol)


@pytest.fixture(scope="module", params=["tiny", "small"])
def models(request, tiny_model, small_model):
    jcfg, jmodel, jparams = tiny_model if request.param == "tiny" \
        else small_model
    return jcfg, jmodel, jparams, port_model(jcfg, jparams)


def test_layers_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    close(jlayers.rmsnorm({"scale": scale}, x, 1e-6),
          tlayers.rmsnorm(t(scale), t(x), 1e-6))
    close(jlayers.rmsnorm_headwise(scale, x), tlayers.rmsnorm_headwise(
        t(scale), t(x)))
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    for theta in (1e4, 1e6):
        close(jlayers.apply_rope(x, pos, theta),
              tlayers.apply_rope(t(x), t(pos), theta))
    h = rng.standard_normal((2, 5, 8)).astype(np.float32)
    p = jlayers.mlp_init(jax.random.PRNGKey(1), 8, 12, "swiglu")
    mlp = tlayers.MLP(8, 12, device="cpu")
    for name in ("w_gate", "w_up", "w_down"):
        getattr(mlp, name).kernel.copy_(t(p[name]["kernel"]))
    close(jlayers.mlp(p, h, "swiglu"), tlayers.mlp(mlp, t(h)))
    table = rng.standard_normal((11, 8)).astype(np.float32)
    toks = rng.integers(0, 11, (2, 4))
    close(jlayers.embed({"table": table}, toks),
          tlayers.embed(t(table), t(toks)))
    close(jlayers.unembed({}, h, tied_table=table),
          tlayers.unembed(t(h), t(table), tied=True))


@pytest.mark.parametrize("causal,window,masked,chunk", [
    (True, 0, False, 512), (True, 7, False, 512), (False, 0, True, 512),
    (True, 0, True, 512), (True, 0, False, 8)])
def test_sdpa_grouped_matches(causal, window, masked, chunk):
    rng = np.random.default_rng(1)
    B, Lq, Lk, H, Hkv, hd = 2, 24, 24, 4, 2, 16
    q = rng.standard_normal((B, Lq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Lk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Lk, Hkv, hd)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((B, Lk)) < 0.8
        mask[:, 0] = True
    exp = jattn.sdpa(q, k, v, causal=causal, window=window, kv_mask=mask,
                     chunk=chunk)
    out = tattn.sdpa(t(q), t(k), t(v), causal=causal, window=window,
                     kv_mask=None if mask is None else t(mask), chunk=chunk)
    close(exp, out)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_prefill_and_decode_match(models, impl):
    """Prefill logits/hidden and three decode steps on dense and paged
    caches; ``cuda`` runs the kernels' plain versions on CPU tensors."""
    jcfg, jmodel, jparams, model = models
    jimpl = {"torch": "xla", "cuda": "pallas"}[impl]
    rng = np.random.default_rng(2)
    B, L, S, ps = 2, 13, 48, 8
    toks = rng.integers(2, jcfg.vocab_size, (B, L)).astype(np.int32)
    jl, jh, jc = jmodel.prefill(jparams, jnp.asarray(toks),
                                jmodel.make_cache(B, S), impl=jimpl)
    with torch.inference_mode():
        tl, th, tc = model.prefill(t(toks, torch.long), model.make_cache(B, S),
                                   impl=impl)
    close(jl, tl, LOGIT_TOL)
    close(jh, th)
    close(jc["super"][0]["k"][:, :, :L], tc["k"][:, :, :L])
    # a paged copy of the same prompt KV: pages out of order
    P = B * (S // ps) + 1
    bt = (1 + rng.permutation(P - 1)[:B * (S // ps)]).reshape(B, -1)
    jp = jmodel.make_paged_cache(B, S, page_size=ps, num_pages=P)
    tp = model.make_paged_cache(B, S, page_size=ps, num_pages=P)
    kp = np.zeros(np.asarray(jp["super"][0]["k_pages"]).shape, np.float32)
    vp = np.zeros_like(kp)
    kd = np.asarray(jc["super"][0]["k"])
    vd = np.asarray(jc["super"][0]["v"])
    for b in range(B):
        for i in range(S // ps):
            kp[:, bt[b, i]] = kd[:, b, i * ps:(i + 1) * ps]
            vp[:, bt[b, i]] = vd[:, b, i * ps:(i + 1) * ps]
    jp = {"super": ({"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp)},),
          "tail": (), "pos": jc["pos"], "block_table": jnp.asarray(bt,
                                                                   jnp.int32)}
    tbt = t(bt, torch.long)
    for b in range(B):       # the port's own prefill KV, same page layout
        for i in range(S // ps):
            tp["k_pages"][:, tbt[b, i]] = tc["k"][:, b, i * ps:(i + 1) * ps]
            tp["v_pages"][:, tbt[b, i]] = tc["v"][:, b, i * ps:(i + 1) * ps]
    tp["block_table"].copy_(t(bt, torch.int32))
    tp["pos"] = tc["pos"].clone()
    for step in range(3):
        tok = rng.integers(2, jcfg.vocab_size, B).astype(np.int32)
        jl, jh, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                        impl=jimpl)
        jpl, _, jp = jmodel.decode_step(jparams, jnp.asarray(tok), jp,
                                        impl=jimpl)
        with torch.inference_mode():
            tl, th, tc = model.decode_step(t(tok, torch.long), tc, impl=impl)
            tpl, _, tp = model.decode_step(t(tok, torch.long), tp, impl=impl)
        close(jl, tl, LOGIT_TOL)
        close(jh, th)
        close(jpl, tpl, LOGIT_TOL)
        if impl == "torch":
            # the plain paged path gathers into the dense view: bit for bit
            assert torch.equal(tl, tpl)


def test_bucketed_prefill_matches(small_model):
    jcfg, jmodel, jparams = small_model
    model = port_model(jcfg, jparams)
    rng = np.random.default_rng(3)
    lens = np.array([5, 16, 11, 1], np.int32)
    toks = rng.integers(2, jcfg.vocab_size, (4, 16)).astype(np.int32)
    jl, jh, jc = jmodel.prefill(jparams, jnp.asarray(toks),
                                jmodel.make_cache(4, 32),
                                lengths=jnp.asarray(lens))
    with torch.inference_mode():
        tl, th, tc = model.prefill(t(toks, torch.long),
                                   model.make_cache(4, 32), lengths=t(lens))
    close(jl, tl, LOGIT_TOL)
    close(jh, th)
    np.testing.assert_array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_kv_quantize_bit_for_bit(name):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 2, 64)) *
         rng.uniform(0.01, 50, (3, 5, 2, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0                          # all-zero row
    x[1, 1, 1, 3] = 1e-3 * x[1, 1, 1].max()   # tiny values next to big ones
    jq, js = jattn.kv_quantize(jnp.asarray(x), jattn.kv_storage_dtype(
        name, jnp.float32)[0])
    tq, ts = tattn.kv_quantize(t(x), tattn.kv_storage_dtype(
        name, torch.float32)[0])
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jq).view(np.uint8),
                                  tq.view(torch.uint8).numpy())
    np.testing.assert_array_equal(
        np.asarray(jattn.kv_dequantize(jq, js)),
        tattn.kv_dequantize(tq, ts).numpy())


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_quantized_paged_decode_matches(tiny_model, name):
    """Layer-level paged decode on an int8/fp8 pool: quantize-on-write plus
    dequantizing attention, against the reference's."""
    jcfg, _, jparams = tiny_model
    model = port_model(jcfg, jparams)
    cfg = model.cfg
    rng = np.random.default_rng(5)
    B, ps, n = 3, 8, 4
    P = B * n + 1
    jattnp = jax.tree.map(lambda a: a[0], jparams["super"][0]["attn"])
    jcache = jattn.make_paged_kv_cache(jcfg, P, ps, jnp.float32, kv_dtype=name)
    kf = rng.standard_normal(jcache["k_pages"].shape).astype(np.float32)
    vf = rng.standard_normal(jcache["v_pages"].shape).astype(np.float32)
    qd = jattn.kv_storage_dtype(name, jnp.float32)[0]
    kq, ks = jattn.kv_quantize(jnp.asarray(kf), qd)
    vq, vs = jattn.kv_quantize(jnp.asarray(vf), qd)
    jcache = {"k_pages": kq, "v_pages": vq, "k_scale": ks, "v_scale": vs}
    tdt = tattn.kv_storage_dtype(name, torch.float32)[0]
    tk = t(np.asarray(kq).view(np.uint8)).view(tdt).clone()
    tv = t(np.asarray(vq).view(np.uint8)).view(tdt).clone()
    tks, tvs = t(ks).clone(), t(vs).clone()
    bt = (1 + rng.permutation(P - 1)[:B * n]).reshape(B, n).astype(np.int32)
    pos = np.array([0, 9, n * ps - 1], np.int32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    for impl, jimpl in (("torch", "xla"), ("cuda", "pallas")):
        exp, jout = jattn.attn_decode_paged(jattnp, jcfg, jnp.asarray(x),
                                            jcache, jnp.asarray(pos),
                                            jnp.asarray(bt), impl=jimpl)
        kp, vp, kss, vss = tk.clone(), tv.clone(), tks.clone(), tvs.clone()
        with torch.inference_mode():
            out = tattn.attn_decode_paged(
                model.layers[0].attn, cfg, t(x), kp, vp, t(pos), t(bt),
                impl=impl, ks=kss, vs=vss)
        close(exp, out)
        np.testing.assert_array_equal(np.asarray(jout["k_pages"]).view(
            np.uint8), kp.view(torch.uint8).numpy())
        np.testing.assert_array_equal(np.asarray(jout["v_scale"]),
                                      vss.numpy())


def test_unsupported_families_raise():
    """Evidence on a decoder-only stack outside the vlm family and gelu
    MoE experts raise; an encoder-decoder stack builds, its encoder taking
    the evidence (served: tests/test_torch_encdec.py), and so does a
    stack of local-attention blocks (the recurrent and hybrid families
    are served: tests/test_torch_recurrent_models.py)."""
    from repro_torch.configs import get_config
    base = get_config("qwen3_0_6b").reduced()
    assert get_config("qwen3-0.6b") is get_config("qwen3_0_6b")
    moe = get_config("granite-moe-3b-a800m").reduced()
    for cfg in (base.with_overrides(num_evidence_tokens=4),
                moe.with_overrides(mlp_activation="gelu")):
        with pytest.raises(NotImplementedError):
            build_model(cfg, device="cpu")
    encdec = build_model(base.with_overrides(
        is_encoder_decoder=True, num_encoder_layers=1, num_evidence_tokens=4,
        evidence_dim=32), device="cpu")
    assert (len(encdec.enc_layers), len(encdec.dec_layers)) == (1, 2)
    assert encdec.evidence_proj is not None and \
        not hasattr(encdec, "layers")
    assert encdec.state_kind == "kv" and not encdec.has_pageable_layers
    local = build_model(base.with_overrides(block_pattern=("local",)),
                        device="cpu")
    assert [blk.kind for blk in local.layers] == ["local", "local"]
    assert local.state_kind == "kv" and not local.has_pageable_layers


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_gelu_relu_mlps_match_reference(activation):
    """The non-gated LM MLPs build ``w_in``/``w_out`` under the reference's
    names (so ``params_from_jax`` carries them as they are) and compute
    the reference's ``mlp``; a model of that config builds."""
    from repro_torch.configs import get_config
    rng = np.random.default_rng(9)
    h = rng.standard_normal((2, 5, 8)).astype(np.float32)
    p = jlayers.mlp_init(jax.random.PRNGKey(2), 8, 12, activation)
    mlp = tlayers.MLP(8, 12, activation, device="cpu")
    assert sorted(n for n, _ in mlp.named_parameters()) == \
        ["w_in.kernel", "w_out.kernel"]
    for name in ("w_in", "w_out"):
        getattr(mlp, name).kernel.copy_(t(p[name]["kernel"]))
    close(jlayers.mlp(p, h, activation), tlayers.mlp(mlp, t(h)))
    cfg = get_config("qwen3_0_6b").reduced().with_overrides(
        mlp_activation=activation)
    model = build_model(cfg, device="cpu")
    assert model.layers[0].mlp.activation == activation
    assert hasattr(model.layers[0].mlp, "w_in")


def test_entry_points_need_a_device_or_cpu():
    from repro_torch import resolve_device
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_windowed_ring_prefill_and_decode_match(small_model):
    """A sliding-window config: the ring is shorter than the prompt, so
    prefill keeps the tail at its ring slots and decode masks by window."""
    jcfg0, jmodel0, jparams = small_model
    from repro.models import build_model as jbuild
    jcfg = jcfg0.with_overrides(attn_window=8)
    jmodel = jbuild(jcfg, jnp.float32)
    model = port_model(jcfg, jparams)
    rng = np.random.default_rng(6)
    toks = rng.integers(2, jcfg.vocab_size, (2, 13)).astype(np.int32)
    jl, _, jc = jmodel.prefill(jparams, jnp.asarray(toks),
                               jmodel.make_cache(2, 32))
    with torch.inference_mode():
        tl, _, tc = model.prefill(t(toks, torch.long), model.make_cache(2, 32))
    assert tc["k"].shape[2] == 8
    close(jl, tl, LOGIT_TOL)
    close(jc["super"][0]["k"], tc["k"])
    for _ in range(3):
        tok = rng.integers(2, jcfg.vocab_size, 2).astype(np.int32)
        jl, _, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc)
        with torch.inference_mode():
            tl, _, tc = model.decode_step(t(tok, torch.long), tc)
        close(jl, tl, LOGIT_TOL)


def test_bfloat16_params_convert_bit_for_bit(tiny_model):
    jcfg, _, jparams = tiny_model
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jparams)
    sd = params_from_jax(tree, port_cfg(jcfg))
    table = sd["embed.table"]
    assert table.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        np.asarray(tree["embed"]["table"]).view(np.uint16),
        table.view(torch.int16).numpy().view(np.uint16))
