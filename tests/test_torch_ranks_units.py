"""Tensor parallelism over ranks, unit by unit, on the CPU.

The placement rules (``sharding.local_shard``, ``place``, ``cut_specs``,
``rank_specs``) against the rule table's specs and plain numpy slicing;
the refusal of a model axis that would cut heads (and what it admits:
one kv head held whole, a gelu MLP, SSD heads and an RG-LRU width that
divide; an encoder-decoder stays refused); and, on two spawned gloo
ranks of a
(1, 2) mesh (``torch_ranks.spawn``: one thread each, a ``FileStore``
under ``tmp_path``), the vocab-parallel embedding and unembedding and a
row-parallel ``Dense`` against the whole tensors, the reduced qwen3's
prefill and decode logits at model=2 against the JAX model's on the same
weights (within 1e-5), and a seeded rank build against the one-device
build: its parameters the one-device model's blocks bit for bit, its
logits (qwen3, and qwen2.5-32b with qkv biases) within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import config as tconfig
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import build_model
from test_torch_engine_camd import _one_torch_thread  # noqa: F401
from torch_ranks import spawn, tp_units

TOL = dict(rtol=1e-5, atol=1e-5)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(tconfig.ModelConfig)}


def _fp32(name):
    return get_config(name).reduced().with_overrides(dtype="float32")


@pytest.fixture(scope="module")
def ranks(small_model, tmp_path_factory):
    """The two ranks' ``tp_units`` outputs, the JAX model's logits on the
    same tokens, and the inputs."""
    jcfg, jmodel, jparams = small_model
    rng = np.random.default_rng(3)
    B, L = 2, 11
    toks = rng.integers(2, jcfg.vocab_size, (B, L)).astype(np.int32)
    dec = [rng.integers(2, jcfg.vocab_size, B).astype(np.int32)
           for _ in range(2)]
    jl, _, jc = jmodel.prefill(jparams, jnp.asarray(toks),
                               jmodel.make_cache(B, 48))
    ref = [np.asarray(jl)]
    for tok in dec:
        jl, _, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc)
        ref.append(np.asarray(jl))
    out = spawn(tp_units, 2, tmp_path_factory.mktemp("units"),
                _fields(jcfg), jax.tree.map(np.asarray, jparams), toks, dec,
                _fields(_fp32("qwen2.5-32b")))
    return out, ref, toks


# ---------------------------------------------------------------------------
# placement, in one process
# ---------------------------------------------------------------------------

def _numpy_block(a, spec, mesh, at):
    """A position's block by numpy's array_split over each sharded dim."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        names = (axes,) if isinstance(axes, str) else axes
        idx, n = 0, 1
        for ax in names:
            idx, n = idx * mesh.shape[ax] + at[ax], n * mesh.shape[ax]
        a = np.array_split(a, n, axis=dim)[idx]
    return a


@pytest.mark.parametrize("at", [dict(data=d, model=m)
                                for d in range(2) for m in range(2)])
def test_place_cuts_the_rule_tables_blocks(at):
    """Every parameter of the reduced qwen3 (and qwen2.5's biases) cut at
    each position of a (2, 2) mesh equals numpy's block under the serving
    specs; a column-parallel projection's bias goes with its columns."""
    mesh = make_local_mesh((2, 2))
    for name in ("qwen3-0.6b", "qwen2.5-32b"):
        cfg = _fp32(name)
        full = build_model(cfg, torch.float32, device="cpu").state_dict()
        specs = shd.serve_param_specs(cfg, full, mesh)
        cuts = shd.cut_specs(specs)
        got = shd.place(full, cuts, mesh, at)
        for key, t in full.items():
            assert cuts[key] == specs[key] or key.endswith(".bias"), key
            np.testing.assert_array_equal(
                got[key].numpy(), _numpy_block(t.numpy(), cuts[key], mesh,
                                               at), err_msg=key)
        assert specs["layers.0.attn.wq.kernel"] == (None, "model")
        assert specs["layers.0.attn.wo.kernel"] == ("model", None)
        assert specs["embed.table"] == ("model", None)
        if cfg.qkv_bias:
            assert specs["layers.0.attn.wq.bias"] == (None,)
            assert cuts["layers.0.attn.wq.bias"] == ("model",)


def test_local_shard_refuses_a_ragged_cut():
    mesh = make_local_mesh((2, 2))
    with pytest.raises(ValueError, match="divide"):
        shd.local_shard(torch.zeros(3, 4), ("model", None), mesh,
                        dict(data=0, model=1))


@pytest.mark.parametrize("name,model,ok", [
    ("qwen3-0.6b", 2, True), ("qwen2.5-32b", 2, True),
    ("granite-34b", 2, True), ("yi-34b", 16, False),
    ("qwen3-0.6b", 4, False)])
def test_model_split_cuts_whole_heads(name, model, ok):
    """H must divide by the model axis and Hkv divide or be the one kv
    head, which every model rank holds whole: the reduced granite-34b's
    4 query heads over one kv head split at model=2 (a gelu MLP too);
    yi-34b's 56 heads under 16 and the reduced qwen3's 2 kv heads under 4
    raise NotImplementedError naming ROADMAP."""
    cfg = get_config(name) if model == 16 else _fp32(name)
    mesh = make_local_mesh((1, model))
    if ok:
        shd.check_model_split(cfg, mesh)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        shd.check_model_split(cfg, mesh)


def test_gelu_mlp_refused_over_a_model_axis():
    """No more refused: a gelu MLP splits over model=2 with ``w_in``'s
    columns and ``w_out``'s rows (``sharding.rank_specs``, divergence D5:
    the rule table cuts ``w_out``'s output dim), so a layer sums once
    over the model group; at (2, 1) it stays whole."""
    cfg = _fp32("qwen3-0.6b").with_overrides(mlp_activation="gelu")
    shd.check_model_split(cfg, make_local_mesh((2, 1)))
    mesh = make_local_mesh((1, 2))
    shd.check_model_split(cfg, mesh)
    shapes = build_model(cfg, torch.float32, device="cpu").state_dict()
    table = shd.serve_param_specs(cfg, shapes, mesh)
    cuts = shd.rank_specs(cfg, shapes, mesh)
    assert table["layers.0.mlp.w_out.kernel"] == (None, "model")
    assert cuts["layers.0.mlp.w_out.kernel"] == ("model", None)
    assert cuts["layers.0.mlp.w_in.kernel"] == (None, "model")
    whole = shd.rank_specs(cfg, shapes, make_local_mesh((2, 1)))
    assert whole["layers.0.mlp.w_out.kernel"] == (None, None)


@pytest.mark.parametrize("name,model,ok,match", [
    ("recurrentgemma-2b", 2, True, None),
    ("recurrentgemma-2b", 4, False, "10 query heads"),
    ("mamba2-780m", 2, True, None), ("mamba2-780m", 4, True, None),
    ("mamba2-780m", 32, False, "48 SSD heads"),
    ("internvl2-2b", 8, False, "vision tower")])
def test_model_split_of_recurrent_and_hybrid_stacks(name, model, ok, match):
    """The published recurrentgemma-2b (10 query heads over one kv head,
    a gelu MLP, an RG-LRU width of 2560) splits at model=2 and its 10
    heads refuse model=4; mamba2-780m's 48 SSD heads split at 2 and 4 and
    refuse 32; a vision tower whose heads do not split whole still
    raises. Every refusal names ROADMAP.md."""
    cfg = get_config(name)
    mesh = make_local_mesh((1, model))
    if ok:
        shd.check_model_split(cfg, mesh)
        return
    with pytest.raises(NotImplementedError, match=f"{match}.*ROADMAP.md"):
        shd.check_model_split(cfg, mesh)


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "granite-34b"])
def test_one_kv_head_held_whole(name):
    """A rank of the reduced recurrentgemma or granite-34b at model=2
    caches the one kv head (``Model.kv_heads`` 1, not 0) beside its 2 of
    4 query heads, ``wk``/``wv`` whole (divergence D6)."""
    from torch_ranks import FakeWorld
    cfg = _fp32(name)
    model = build_model(cfg, torch.float32, device="cpu",
                        world=FakeWorld(1, 2, rank=1))
    attn = next(b.attn for b in model.layers if hasattr(b, "attn"))
    hd = cfg.resolved_head_dim
    assert model.kv_heads == 1
    assert tuple(attn.wk.kernel.shape) == (cfg.d_model, hd)
    assert tuple(attn.wq.kernel.shape) == (cfg.d_model, 2 * hd)
    assert model.make_cache(2, 16)["k"].shape[3] == 1


def test_encoder_decoder_still_refused_over_ranks():
    """``check_rank_supported`` refuses seamless on any rank world,
    naming step 4 of ROADMAP.md Queue 1 item 5."""
    from repro_torch.models.model import check_rank_supported
    from torch_ranks import FakeWorld
    cfg = _fp32("seamless-m4t-large-v2")
    for world in (FakeWorld(2, 1), FakeWorld(1, 2)):
        with pytest.raises(NotImplementedError,
                           match="Queue 1 item 5, step 4"):
            check_rank_supported(cfg, world)


# ---------------------------------------------------------------------------
# two model ranks
# ---------------------------------------------------------------------------

def test_vocab_parallel_embed_is_exact(ranks):
    out, _, _ = ranks
    inp = out[0]["inputs"]
    for r in out:
        np.testing.assert_array_equal(r["embed"],
                                      inp["table"][inp["tokens"]])


def test_vocab_parallel_unembed_gathers_every_column(ranks):
    out, _, _ = ranks
    inp = out[0]["inputs"]
    exp = inp["h"] @ inp["table"].T
    for r in out:
        assert r["unembed"].shape == exp.shape
        np.testing.assert_allclose(r["unembed"], exp, **TOL)


def test_row_parallel_dense_reduces(ranks):
    out, _, _ = ranks
    inp = out[0]["inputs"]
    exp = inp["x"] @ inp["kernel"]
    np.testing.assert_array_equal(out[0]["dense"], out[1]["dense"])
    np.testing.assert_allclose(out[0]["dense"], exp, **TOL)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("step", [0, 1, 2])
def test_tp2_logits_match_jax(ranks, impl, step):
    """Prefill (step 0) and two decode steps of the reduced qwen3 at
    model=2 on the reference's weights, against the JAX model's: within
    1e-5, the same on both ranks, each rank caching its one kv head."""
    out, ref, _ = ranks
    for r in out:
        np.testing.assert_allclose(r[f"logits_{impl}"][step], ref[step],
                                   **TOL)
        assert r["kv_heads"] == 1
    np.testing.assert_array_equal(out[0][f"logits_{impl}"][step],
                                  out[1][f"logits_{impl}"][step])


@pytest.mark.parametrize("name", ["qwen3", "qwen2.5"])
def test_seeded_rank_build_is_the_one_device_models_blocks(ranks, name):
    """A rank's seeded build holds the seeded one-device model's blocks
    bit for bit, and its logits are the one-device model's within
    1e-5."""
    out, _, toks = ranks
    cfg = _fp32("qwen3-0.6b" if name == "qwen3" else "qwen2.5-32b")
    full = build_model(cfg, torch.float32, device="cpu", seed=0)
    with torch.inference_mode():
        exp, _, _ = full.prefill(torch.as_tensor(toks, dtype=torch.long),
                                 full.make_cache(toks.shape[0], 48))
    mesh = make_local_mesh((1, 2))
    cuts = shd.cut_specs(shd.serve_param_specs(cfg, full.state_dict(), mesh))
    for m, r in enumerate(out):
        params, logits = r["seeded"][name]
        want = shd.place(full.state_dict(), cuts, mesh, dict(data=0, model=m))
        assert set(params) == set(want)
        for key in want:
            np.testing.assert_array_equal(params[key], want[key].numpy(),
                                          err_msg=key)
        np.testing.assert_allclose(logits, exp.numpy(), **TOL)
