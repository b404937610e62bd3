"""The port's recurrent and hybrid models against the JAX package's, on
the CPU: mamba2-780m (SSD blocks) and recurrentgemma-2b (RG-LRU blocks
and local attention).

Both configs equal the reference's field for field, at full and reduced
size, with the reference's parameter count. At ``reduced()`` size in
fp32, with the reference's weights carried over by ``params_from_jax``
and inputs made by numpy from a seed, the port's prefill logits, hidden
states and every cache leaf, four decode steps' logits and the
full-sequence forward agree with the reference's within 1e-4 abs + 1e-4
rel: the SSD block's 4-operand einsums contract in another order under
``torch.einsum``, and the RG-LRU's log-depth scan is another tree of the
same combine than ``lax.associative_scan``, so the two are allclose, not
bit for bit. Prompt lengths are not multiples of the reduced SSD chunk
(16), and one prompt of 80 tokens outruns the reduced local window of 64,
so that the hybrid's ring keeps the prompt's tail. A ``lengths``-masked
batched prefill equals per-row prefills within the same tolerance. A
3-layer hybrid at H 10 / Hkv 1, hd 256 (recurrentgemma's attention shape,
which K2 and K3 serve on the card) runs through the kernels' plain
versions. Every config both registries hold reports the reference's
``state_kind`` and ``capabilities()``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.models import build_model as jbuild
from repro.models import rglru as jrglru
from repro_torch import config as tconfig
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import params_from_jax
from repro_torch.models import rglru as trglru
from repro_torch.models.model import build_model
from torch_ranks import _one_torch_thread  # noqa: F401

ARCHS = ("mamba2-780m", "recurrentgemma-2b")
TOL = dict(rtol=1e-4, atol=1e-4)


def port_cfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(tconfig.ModelConfig)}
    if jcfg.ssm is not None:
        kw["ssm"] = tconfig.SSMConfig(**dataclasses.asdict(jcfg.ssm))
    if jcfg.rglru is not None:
        kw["rglru"] = tconfig.RGLRUConfig(**dataclasses.asdict(jcfg.rglru))
    return tconfig.ModelConfig(**kw)


def make_pair(jcfg):
    jmodel = jbuild(jcfg, jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    model = build_model(cfg, torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg))
    return jmodel, jparams, model


@pytest.fixture(scope="module")
def pairs():
    """arch -> (jcfg, jmodel, jparams, port model) at reduced() size in
    fp32, made once a module."""
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


_LEAVES = {"attn": {"k": "k", "v": "v"}, "ssm": {"ssd": "ssd",
                                                "conv": "ssm_conv"},
           "rglru": {"h": "h", "conv": "rglru_conv"}}


def jax_leaves(jcfg, jcache):
    """The reference's cache ({"super": per pattern position, stacked
    over super-blocks; "tail"; "pos"}) in the port's layout: each kind's
    leaves stacked over its layers in layer order."""
    pat = jcfg.block_pattern
    n_super = jcfg.num_layers // len(pat)
    per_layer = [jax.tree.map(lambda a, i=i: np.asarray(a[i]),
                              jcache["super"][p])
                 for i in range(n_super) for p in range(len(pat))]
    per_layer += [jax.tree.map(np.asarray, e) for e in jcache["tail"]]
    out = {}
    for kind, entry in zip(jcfg.layer_kinds, per_layer):
        group = "attn" if kind in ("attn", "local") else kind
        for key, leaf in _LEAVES[group].items():
            out.setdefault(leaf, []).append(entry[key])
    out = {k: np.stack(v) for k, v in out.items()}
    out["pos"] = np.asarray(jcache["pos"])
    return out


def assert_cache_close(jcfg, jcache, cache):
    exp = jax_leaves(jcfg, jcache)
    assert set(exp) == set(cache)
    for name, leaf in cache.items():
        assert tuple(leaf.shape) == exp[name].shape, name
        close(exp[name], leaf)


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# configs and capabilities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_config_equals_reference(name):
    """Field for field the reference's under both spellings, full and
    reduced, with the reference's parameter count; the reduced model in
    bf16 builds its blocks under the reference's names, fp32 where the
    reference's are."""
    cfg = get_config(name)
    assert get_config(name.replace("-", "_").replace(".", "_")) is cfg
    assert name in list_configs()
    jcfg = jget_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert cfg.num_params() == jcfg.num_params()
    assert cfg.reduced().num_params() == jcfg.reduced().num_params()
    model = build_model(cfg.reduced(), torch.bfloat16, device="cpu")
    jp = jbuild(jcfg.reduced(), jnp.bfloat16).init(jax.random.PRNGKey(0))
    flat = params_from_jax(jax.tree.map(np.asarray, jp), port_cfg(
        jcfg.reduced()))
    params = dict(model.named_parameters())
    assert set(flat) == set(params)
    for key, val in flat.items():
        assert val.shape == params[key].shape and \
            val.dtype == params[key].dtype, key
    fp32 = {k for k, v in params.items() if v.dtype == torch.float32}
    assert fp32 == {k for k in params if k.rsplit(".", 1)[-1] in (
        "A_log", "D", "dt_bias", "lam")} and fp32


def test_capabilities_equal_reference():
    """state_kind and capabilities() of every config both registries hold
    (mamba2 recurrent, recurrentgemma hybrid, the attention-only ones
    kv)."""
    both = sorted(set(list_configs()) & set(jlist_configs()))
    assert set(ARCHS) <= set(both)
    kinds = {}
    for name in both:
        jcfg = jget_config(name).reduced()
        jcaps = jbuild(jcfg, jnp.float32).capabilities()
        model = build_model(port_cfg(jcfg), device="cpu")
        assert model.capabilities() == jcaps, name
        kinds[name] = model.state_kind
    assert kinds["mamba2-780m"] == "recurrent"
    assert kinds["recurrentgemma-2b"] == "hybrid"
    assert kinds["qwen3-0.6b"] == "kv"


# ---------------------------------------------------------------------------
# prefill, decode, forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,L", [("mamba2-780m", 11),
                                    ("mamba2-780m", 37),
                                    ("recurrentgemma-2b", 11),
                                    ("recurrentgemma-2b", 80)])
def test_prefill_and_decode_match(pairs, name, L):
    """Prefill logits, hidden states and every cache leaf, then four
    decode steps' logits and leaves, the reference's Pallas impl against
    the port's kernel impl (plain versions on the CPU). L 11 and 37 are no
    multiple of the SSD chunk of 16; L 80 outruns the local ring of 64."""
    jcfg, jmodel, jparams, model = pairs(name)
    rng = np.random.default_rng(L)
    B, S = 2, 96
    toks = rng.integers(2, jcfg.vocab_size, (B, L)).astype(np.int32)
    jl, jh, jc = jmodel.prefill(jparams, jnp.asarray(toks),
                                jmodel.make_cache(B, S), impl="pallas")
    with torch.inference_mode():
        tl, th, tc = model.prefill(t(toks).long(), model.make_cache(B, S),
                                   impl="cuda")
    close(jl, tl)
    close(jh, th)
    assert_cache_close(jcfg, jc, tc)
    for step in range(4):
        tok = rng.integers(2, jcfg.vocab_size, B).astype(np.int32)
        jl, _, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                       impl="pallas")
        with torch.inference_mode():
            tl, _, tc = model.decode_step(t(tok).long(), tc, impl="cuda")
        close(jl, tl)
    assert_cache_close(jcfg, jc, tc)


@pytest.mark.parametrize("name", ARCHS)
def test_masked_prefill_matches_per_row(pairs, name):
    """Right-padded rows with ``lengths`` against each row prefilled
    alone: last-token logits and every cache leaf (the reference's
    ``test_masked_prefill_matches_per_row``), and the batched prefill
    against the reference's batched prefill."""
    jcfg, jmodel, jparams, model = pairs(name)
    rng = np.random.default_rng(5)
    lens = [13, 4, 29]
    Lp, S = 32, 64
    toks = np.zeros((len(lens), Lp), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(2, jcfg.vocab_size, n)
    ln = np.asarray(lens, np.int32)
    with torch.inference_mode():
        bl, bh, bc = model.prefill(t(toks).long(), model.make_cache(3, S),
                                   lengths=t(ln))
        for i, n in enumerate(lens):
            rl, rh, rc = model.prefill(t(toks[i:i + 1, :n]).long(),
                                       model.make_cache(1, S))
            close(rl.numpy(), bl[i:i + 1])
            close(rh.numpy(), bh[i:i + 1])
            for key, leaf in bc.items():
                row = leaf[i:i + 1] if key == "pos" else leaf[:, i:i + 1]
                if key in ("k", "v"):     # pad keys past a row's length
                    row, ref_row = row[:, :, :n], rc[key][:, :, :n]
                else:
                    ref_row = rc[key]
                close(ref_row.numpy(), row)
    jl, jh, jc = jmodel.prefill(jparams, jnp.asarray(toks),
                                jmodel.make_cache(3, S),
                                lengths=jnp.asarray(ln))
    close(jl, bl)
    close(jh, bh)
    exp = jax_leaves(jcfg, jc)
    for key in ("ssd", "ssm_conv", "h", "rglru_conv", "pos"):
        if key in bc:
            close(exp[key], bc[key])


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(pairs, name):
    """The full-sequence forward (training and scoring): every position's
    logits and hidden state, no aux terms (no MoE layer)."""
    jcfg, jmodel, jparams, model = pairs(name)
    rng = np.random.default_rng(7)
    toks = rng.integers(2, jcfg.vocab_size, (2, 45)).astype(np.int32)
    jl, jh, jaux = jmodel.forward(jparams, jnp.asarray(toks))
    with torch.inference_mode():
        tl, th, taux = model.forward(t(toks).long())
    close(jl, tl)
    close(jh, th)
    assert jaux == {} and taux == {}


def test_hybrid_at_served_attention_shape():
    """A 3-layer recurrentgemma (RG-LRU, RG-LRU, local attention) at
    recurrentgemma's attention shape, H 10 over one kv head of width 256,
    d 640: prefill of a prompt past the reduced window and four decode
    steps, the kernel impls' plain versions against the reference's Pallas
    impl."""
    base = jget_config("recurrentgemma-2b").reduced()
    jcfg = base.with_overrides(d_model=640, num_heads=10, num_kv_heads=1,
                               head_dim=256, dtype="float32",
                               rglru=dataclasses.replace(base.rglru,
                                                         lru_width=640))
    jmodel, jparams, model = make_pair(jcfg)
    assert model.layers[2].attn.wq.kernel.shape == (640, 2560)
    rng = np.random.default_rng(11)
    toks = rng.integers(2, jcfg.vocab_size, (2, 70)).astype(np.int32)
    jl, _, jc = jmodel.prefill(jparams, jnp.asarray(toks),
                               jmodel.make_cache(2, 96), impl="pallas")
    with torch.inference_mode():
        tl, _, tc = model.prefill(t(toks).long(), model.make_cache(2, 96),
                                  impl="cuda")
    close(jl, tl)
    assert tc["k"].shape == (1, 2, 64, 1, 256)
    for step in range(4):
        tok = rng.integers(2, jcfg.vocab_size, 2).astype(np.int32)
        jl, _, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                       impl="pallas")
        with torch.inference_mode():
            tl, _, tc = model.decode_step(t(tok).long(), tc, impl="cuda")
        close(jl, tl)
    assert_cache_close(jcfg, jc, tc)


def test_decode_writes_state_in_place(pairs):
    """Decode updates every recurrent leaf in its own storage (a captured
    graph replays fixed addresses), and a step with ``go`` False leaves
    the state as it was while the positions still advance."""
    _, _, _, model = pairs("recurrentgemma-2b")
    cache = model.make_cache(2, 32)
    with torch.inference_mode():
        model.prefill(torch.tensor([[5, 6, 7], [8, 9, 10]]), cache)
        ptrs = {k: v.data_ptr() for k, v in cache.items()}
        before = {k: v.clone() for k, v in cache.items()}
        model.decode_step(torch.tensor([3, 4]), cache,
                          go=torch.tensor(False))
        for key in ("h", "rglru_conv"):
            assert torch.equal(cache[key], before[key]), key
        model.decode_step(torch.tensor([3, 4]), cache,
                          go=torch.tensor(True))
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    for key in ("h", "rglru_conv"):
        assert not torch.equal(cache[key], before[key]), key
    assert cache["pos"].tolist() == [5, 5]


@pytest.mark.parametrize("L", [1, 2, 7, 64, 100])
def test_linear_scan_matches_associative_scan(L):
    """The RG-LRU recurrence as a Hillis-Steele scan against the
    reference's ``lax.associative_scan`` of the same combine, within
    1e-5 (fp32, decays exp(-8 softplus(lam) r) in (0, 1))."""
    rng = np.random.default_rng(L)
    la = -rng.uniform(0, 6, (2, L, 8)).astype(np.float32)
    b = rng.standard_normal((2, L, 8)).astype(np.float32)

    def combine(left, right):
        return left[0] + right[0], jnp.exp(right[0]) * left[1] + right[1]
    _, exp = jax.jit(lambda x, y: jax.lax.associative_scan(
        combine, (x, y), axis=1))(jnp.asarray(la), jnp.asarray(b))
    close(exp, trglru.linear_scan(t(la), t(b)), dict(rtol=1e-5, atol=1e-5))
    assert jrglru._C == trglru._C
