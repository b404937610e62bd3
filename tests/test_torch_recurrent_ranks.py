"""The recurrent and hybrid models over ranks against the JAX package, on
the CPU.

The reduced mamba2-780m (2 SSD layers, d 256, 16 heads of 32, state 16)
and recurrentgemma-2b (RG-LRU, RG-LRU, local attention; d 256, 4 query
heads over one kv head of 64, a gelu MLP) with the reference's weights
run as spawned gloo ranks (``torch_ranks.spawn``), each rank holding its
blocks (``convert.rank_params``, cut by ``sharding.rank_specs``). One
spawn of two ranks runs the layers at (1, 2) and serves at (1, 2) and
(2, 1), one of four ranks serves at (2, 2); the JAX references run in
two subprocesses on four forced host devices, started beside the ranks.

- Layers at (1, 2), against the reference's whole layer on the same
  inputs, within 1e-5: ``ssm_prefill``/``ssm_decode`` (a rank's 8 of 16
  heads, B and C whole; the gated norm's sum of squares over the model
  group), ``rglru_prefill``/``rglru_decode`` (128 of the 256 channels;
  the gates read the gathered conv output), the gelu MLP (``w_out``
  row-parallel, divergence D5) and the local attention on both impls
  (2 of 4 query heads beside the one kv head held whole, divergence
  D6); every rank's block of each state leaf.
- Served streams: greedy on ``torch`` and ``cuda`` (4 requests: at dp 2
  request 1's candidate sits in slot 1 on shard 0 while its arena row
  lies on shard 1) and CAMD on ``cuda`` with ``RankNoise`` and three
  candidates a round (a round spans both shards) at (1, 2), (2, 1) and
  (2, 2), against the JAX engine on the same forced-host mesh (the
  reference serves both models on every one of them), whose ``xla``
  impl is the reference of the port's both impls here: tokens,
  candidates, rounds, admissions, steps, host syncs and
  ``arena_stats()`` equal; sum_lp, score, p* and the best score within
  1e-5. At dp 2 every rank fetched an arena row across shards and a
  data rank held it in a mirror row.
- A rank's blocks from ``convert.rank_params`` equal those of a seeded
  ``build_model(cfg, world=...)`` (the same draws), for both families at
  every position of (1, 2), (2, 1) and (2, 2).
"""
import inspect
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch.convert import flat_from_jax, rank_params
from repro_torch.distributed import sharding as shd
from repro_torch.models.model import build_model
from torch_ranks import _one_torch_thread  # noqa: F401
from torch_ranks import (GOLDEN_CAMD, ROOT, FakeWorld, config_fields,
                         digest, port_config, recurrent_ranks, spawn,
                         subprocess_env)

TOL = 1e-5
ARCHS = ("mamba2-780m", "recurrentgemma-2b")
SEED = 5
B, L, RING = 2, 13, 32          # L: no multiple of the reduced SSD chunk
SPAN = dict(samples_per_round=3)           # a round spans both shards
CASES = {
    "greedy_torch": (dict(mode="greedy", impl="torch", macro_steps=8), 4, 9),
    "greedy_cuda": (dict(mode="greedy", impl="cuda", macro_steps=8), 4, 9),
    "camd_cuda": (dict(mode="camd", impl="cuda", macro_steps=8, camd=SPAN),
                  3, 9),
}
MESHES = ((1, 2), (2, 1), (2, 2))
GRID = [(arch, mesh, case) for arch in ARCHS for mesh in MESHES
        for case in CASES]

SNIPPET = r"""
import importlib.util, json, os, sys
import jax, jax.numpy as jnp, numpy as np
from repro.config import CAMDConfig, PagedKVConfig
from repro.configs import get_config
from repro.launch.mesh import make_serve_mesh
from repro.models import build_model
spec = importlib.util.spec_from_file_location(
    "make_golden_fifo", os.path.join("tests", "data", "make_golden_fifo.py"))
gold = importlib.util.module_from_spec(spec)
spec.loader.exec_module(gold)
assert jax.device_count() == 4, jax.devices()
%s
golden_camd, runs = json.loads(sys.argv[1])
out, built = [], {}
for arch, (dp, mp), name, (kw, n, plen) in runs:
    if arch not in built:
        cfg = get_config(arch).reduced().with_overrides(dtype="float32")
        model = build_model(cfg, jnp.float32)
        built[arch] = (cfg, model, model.init(jax.random.PRNGKey(0)))
    cfg, model, params = built[arch]
    # the reference's plain impl for both of the port's
    kw = dict(kw, impl="xla")
    kw["paged_kv"] = PagedKVConfig(page_size=8)
    kw["camd"] = CAMDConfig(**{**golden_camd, **kw.pop("camd", {})})
    eng = gold.make_engine(model, params, mesh=make_serve_mesh(dp, model=mp),
                           **kw)
    admitted = []
    admit = eng._admit
    def spy(req, slot_ids, limit=None, admit=admit):
        admitted.append([int(req.uid), [int(s) for s in slot_ids]])
        return admit(req, slot_ids, limit=limit)
    eng._admit = spy
    gold.submit(eng, cfg, n=n, plen=plen)
    res = eng.run()
    eng.arena.check()
    out.append([arch, [dp, mp], name, {
        "admitted": admitted, "streams": digest(res),
        "host_syncs": eng.host_syncs, "total_steps": eng.total_steps,
        "arena": eng.arena_stats()}])
print(json.dumps(out))
""" % inspect.getsource(digest)
# the JAX references in two subprocesses, a model each
JAX_GROUPS = tuple(tuple((mesh, case) for mesh in MESHES for case in CASES)
                   for _ in ARCHS)


def _jax_reference(arch, group):
    """The JAX engine's records of ``arch``'s (mesh, case)s in a
    subprocess with four forced host devices (started, not waited
    for)."""
    arg = json.dumps([GOLDEN_CAMD, [(arch, mesh, case, CASES[case])
                                    for mesh, case in group]])
    return subprocess.Popen([sys.executable, "-c", SNIPPET, arg], cwd=ROOT,
                            env=subprocess_env(4), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX config, the reference's numpy weights, the port
    config) at reduced size in fp32."""
    out = {}
    for arch in ARCHS:
        jcfg = jget_config(arch).reduced().with_overrides(dtype="float32")
        params = jax.tree.map(np.asarray, jbuild(jcfg, jnp.float32).init(
            jax.random.PRNGKey(0)))
        out[arch] = (jcfg, params, port_config(config_fields(jcfg)))
    return out


@pytest.fixture(scope="module")
def inputs(models):
    d = models[ARCHS[0]][0].d_model
    rng = np.random.default_rng(SEED)
    return (rng.standard_normal((B, L, d)).astype(np.float32),
            rng.standard_normal((B, 1, d)).astype(np.float32))


@pytest.fixture(scope="module")
def runs(models, inputs, tmp_path_factory):
    """The two spawns' records by rank and the JAX subprocesses' records,
    the subprocesses running beside the ranks."""
    procs = [_jax_reference(arch, group)
             for arch, group in zip(ARCHS, JAX_GROUPS)]
    x, x1 = inputs

    def serves(meshes):
        return [(config_fields(models[arch][0]), models[arch][1], mesh,
                 [(case,) + CASES[case] for case in CASES])
                for arch in ARCHS for mesh in meshes]
    units = [(config_fields(models[arch][0]), models[arch][1], x, x1, RING)
             for arch in ARCHS]
    try:
        two = spawn(recurrent_ranks, 2, tmp_path_factory.mktemp("rec2"),
                    units, serves(((1, 2), (2, 1))))
        four = spawn(recurrent_ranks, 4, tmp_path_factory.mktemp("rec4"),
                     [], serves(((2, 2),)))
    finally:
        outs = [(p, p.communicate(timeout=300)) for p in procs]
    ref = {}
    for p, (stdout, stderr) in outs:
        assert p.returncode == 0, stderr[-3000:]
        for arch, mesh, case, rec in json.loads(stdout.strip()
                                                .splitlines()[-1]):
            ref[arch, tuple(mesh), case] = rec
    return {"two": two, "four": four, "ref": ref}


# ---------------------------------------------------------------------------
# layers at (1, 2)
# ---------------------------------------------------------------------------

def _layer_params(jcfg, params, i):
    """The reference's params of layer i (a reduced config has no tail)."""
    pat = jcfg.block_pattern
    return jax.tree.map(lambda a: jnp.asarray(a[i // len(pat)]),
                        params["super"][i % len(pat)])


def _half(a, m, axis=-1):
    n = a.shape[axis] // 2
    return np.take(a, np.arange(m * n, (m + 1) * n), axis=axis)


def _close(got, want, what):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=what)


def _layers(models, arch, kind):
    jcfg = models[arch][0]
    return [i for i, k in enumerate(jcfg.layer_kinds) if k == kind]


def test_ssm_layers_on_model_ranks_match_reference(models, inputs, runs):
    """Each SSD layer on both model ranks: the output of prefill and of a
    decode step (``out_proj`` summed over the model group, the gated
    norm's squares too) within 1e-5 of the reference's whole layer; the
    rank's 8 heads of the SSD state and its conv channels (its x block,
    B and C whole) within 1e-5 of the reference's."""
    jcfg, params, _ = models["mamba2-780m"]
    x, x1 = inputs
    inner = jcfg.ssm.expand * jcfg.d_model
    for i in _layers(models, "mamba2-780m", "ssm"):
        lp = _layer_params(jcfg, params, i)["ssm"]
        y, st = jssm.ssm_prefill(lp, jcfg, jnp.asarray(x))
        y1, st1 = jssm.ssm_decode(lp, jcfg, jnp.asarray(x1), st)
        for m, rec in enumerate(runs["two"]):
            got = rec["units"][0][i]
            for step, (want_y, want_st) in (("prefill", (y, st)),
                                            ("decode", (y1, st1))):
                got_y, got_st = got[step]
                _close(got_y, want_y, f"layer {i} {step} rank {m}")
                _close(got_st["ssd"], _half(np.asarray(want_st["ssd"]), m,
                                            axis=1), f"{step} ssd")
                conv = np.asarray(want_st["conv"])
                _close(got_st["conv"], np.concatenate(
                    [_half(conv[..., :inner], m), conv[..., inner:]], -1),
                    f"{step} conv")
                assert got_st["ssd"].shape[1] == 8


def test_rglru_layers_on_model_ranks_match_reference(models, inputs, runs):
    """Each RG-LRU layer on both model ranks: prefill and decode outputs
    within 1e-5 of the reference's whole layer, the rank's 128 channels
    of h and of the conv tail within 1e-5."""
    jcfg, params, _ = models["recurrentgemma-2b"]
    x, x1 = inputs
    for i in _layers(models, "recurrentgemma-2b", "rglru"):
        lp = _layer_params(jcfg, params, i)["rglru"]
        y, st = jrglru.rglru_prefill(lp, jcfg, jnp.asarray(x))
        y1, st1 = jrglru.rglru_decode(lp, jcfg, jnp.asarray(x1), st)
        for m, rec in enumerate(runs["two"]):
            got = rec["units"][1][i]
            for step, (want_y, want_st) in (("prefill", (y, st)),
                                            ("decode", (y1, st1))):
                got_y, got_st = got[step]
                _close(got_y, want_y, f"layer {i} {step} rank {m}")
                for key in ("h", "conv"):
                    _close(got_st[key], _half(np.asarray(want_st[key]), m),
                           f"layer {i} {step} {key}")
                assert got_st["h"].shape == (B, 128)


def test_gelu_mlp_row_parallel_matches_reference(models, inputs, runs):
    """Every gelu MLP of the reduced recurrentgemma on both model ranks
    (``w_in`` columns, ``w_out`` rows summed over the model group: D5)
    within 1e-5 of the reference's whole MLP."""
    jcfg, params, _ = models["recurrentgemma-2b"]
    x, _ = inputs
    for i in range(jcfg.num_layers):
        lp = _layer_params(jcfg, params, i)["mlp"]
        want = jlayers.mlp(lp, jnp.asarray(x), "gelu")
        for m, rec in enumerate(runs["two"]):
            _close(rec["units"][1][i]["mlp"], want, f"layer {i} rank {m}")


def test_one_kv_head_attention_matches_reference(models, inputs, runs):
    """The local layer on both model ranks and both impls: each rank's 2
    of 4 query heads beside the one kv head it holds whole (D6;
    ``Model.kv_heads`` 1, not 0): prefill and a decode step within 1e-5
    of the reference's whole layer, the ring's K/V the reference's."""
    jcfg, params, _ = models["recurrentgemma-2b"]
    x, x1 = inputs
    for i in _layers(models, "recurrentgemma-2b", "local"):
        lp = _layer_params(jcfg, params, i)["attn"]
        win = jcfg.local_window
        pos = jnp.arange(L)[None].repeat(B, 0)
        y, (k, v) = jattn.attn_prefill(lp, jcfg, jnp.asarray(x), pos,
                                       window=win)
        cache = jattn.prefill_into_cache(
            jattn.make_kv_cache(jcfg, B, RING, jnp.float32), k, v)
        y1, cache = jattn.attn_decode(lp, jcfg, jnp.asarray(x1), cache,
                                      jnp.full((B,), L, jnp.int32),
                                      window=win)
        for m, rec in enumerate(runs["two"]):
            got = rec["units"][1][i]
            assert got["q_heads"] == 2 and rec["units"][1]["kv_heads"] == 1
            for impl in ("torch", "cuda"):
                got_y, got_y1, ring = got[impl]
                _close(got_y, y, f"prefill {impl} rank {m}")
                _close(got_y1, y1, f"decode {impl} rank {m}")
                for key in ("k", "v"):
                    _close(ring[key], cache[key], f"{key} {impl}")


# ---------------------------------------------------------------------------
# served streams
# ---------------------------------------------------------------------------

def _ranks_of(runs, mesh):
    return runs["two"] if mesh[0] * mesh[1] == 2 else runs["four"]


def _tokens(streams):
    floats = ("sum_lp", "score", "p_star", "best_score")
    return [{k: v for k, v in s.items() if k not in floats}
            for s in streams]


@pytest.mark.parametrize(
    "key", GRID, ids=[f"{a.split('-')[0]}-{m[0]}x{m[1]}-{c}"
                      for a, m, c in GRID])
def test_recurrent_rank_streams_equal_reference(models, runs, key):
    """Every rank's tokens, candidates, rounds, admissions, steps, host
    syncs and ``arena_stats()`` (the reference's keys) equal the JAX
    engine's on the same mesh; sum_lp, score, p* and the best score
    within 1e-5; the ranks alike. A rank holds its shard's arena rows,
    and at dp 2 a mirror row a slot of its shard: every rank fetched a
    row across shards and one held it."""
    arch, mesh, case = key
    ref = runs["ref"][key]
    recs = [r["serve"][arch, mesh][case] for r in _ranks_of(runs, mesh)]
    dp = mesh[0]
    for rank, rec in enumerate(recs):
        assert _tokens(rec["streams"]) == _tokens(ref["streams"]), rank
        assert rec["admitted"] == ref["admitted"]
        assert (rec["total_steps"], rec["host_syncs"]) == \
            (ref["total_steps"], ref["host_syncs"])
        arena = json.loads(json.dumps(rec["arena"]))
        assert {k: arena[k] for k in ref["arena"]} == ref["arena"]
        for got, want in zip(rec["streams"], ref["streams"]):
            for k in ("sum_lp", "score"):
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL)
            for k in ("p_star", "best_score"):
                assert abs(got[k] - want[k]) <= TOL, (k, got, want)
        assert rec["streams"] == recs[0]["streams"]
        assert rec["B_local"] == 4 // dp
        own = arena["rank"]
        assert (own["rows"], own["mirror_rows"]) == \
            (arena["num_rows"] // dp, 4 // dp if dp > 1 else 0)
        if dp > 1:
            assert own["row_fetches"] > 0, rank
    if dp > 1:
        assert max(r["arena"]["rank"]["mirror_peak"] for r in recs) >= 1


# ---------------------------------------------------------------------------
# rank_params and the seeded build agree
# ---------------------------------------------------------------------------

def _tree_from_state(cfg, state):
    """A port state dict as the reference's tree (layers stacked on a
    leading axis a pattern position; a reduced config has no tail), with
    numpy leaves: the input of ``convert.rank_params``."""
    pat = cfg.block_pattern
    n_super = cfg.num_layers // len(pat)
    tree = {"super": [{} for _ in pat]}

    def put(node, names, leaf):
        for n in names[:-1]:
            node = node.setdefault(n, {})
        node[names[-1]] = leaf
    for key, t in state.items():
        names = key.split(".")
        if names[0] != "layers":
            put(tree, names, t.numpy())
        elif int(names[1]) < len(pat):
            p = int(names[1])
            put(tree["super"][p], names[2:], np.stack(
                [state[f"layers.{i * len(pat) + p}." + ".".join(names[2:])]
                 .numpy() for i in range(n_super)]))
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_params_equal_the_rank_build(models, arch):
    """At every position of (1, 2), (2, 1) and (2, 2), the blocks
    ``convert.rank_params`` cuts from the seeded one-device model's
    weights equal a seeded ``build_model(cfg, world=...)``'s bit for bit
    (``sharding.rank_specs`` in both): the SSD ``in_proj`` by part, B
    and C whole, the RG-LRU's ``lam`` and ``conv_b`` cut, the gelu
    MLP's ``w_out`` and the one kv head's ``wk``/``wv`` as D5 and D6 say,
    while the rule table's specs are the reference's."""
    cfg = models[arch][2]
    whole = build_model(cfg, torch.float32, device="cpu", seed=0)
    tree = _tree_from_state(cfg, whole.state_dict())
    assert set(flat_from_jax(tree, cfg)) == set(whole.state_dict())
    for dp, mp in MESHES:
        for r in range(dp * mp):
            world = FakeWorld(dp, mp, rank=r)
            got = rank_params(tree, cfg, world)
            built = build_model(cfg, torch.float32, device="cpu", seed=0,
                                world=world).state_dict()
            assert set(got) == set(built)
            for k in built:
                assert torch.equal(got[k], built[k]), (k, dp, mp, r)
    shapes = whole.state_dict()
    table = shd.serve_param_specs(cfg, shapes, FakeWorld(1, 2))
    cuts = shd.rank_specs(cfg, shapes, FakeWorld(1, 2))
    if arch == "mamba2-780m":
        key = "layers.0.ssm.in_proj.kernel"
        assert table[key] == (None, "model")
        assert isinstance(cuts[key][1], shd.Parts)
        assert tuple(got["layers.0.ssm.in_proj.kernel"].shape) == \
            (cfg.d_model, 256 + 256 + 2 * 16 + 8)
    else:
        assert table["layers.0.mlp.w_out.kernel"] == (None, "model")
        assert cuts["layers.0.mlp.w_out.kernel"] == ("model", None)
        assert table["layers.2.attn.wk.kernel"] == (None, "model")
        assert cuts["layers.2.attn.wk.kernel"] == (None, None)
        assert cuts["layers.0.rglru.lam"] == ("model",)
