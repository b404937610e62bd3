"""The vlm over ranks against the JAX package, on the CPU.

The reduced llava-1.5-7b (2 layers, d 256, 4/2 heads, vocabulary 512; a
2-layer d-64 tower of 2 heads, 8 image tokens) with the reference's
weights, each rank holding its blocks (``convert.rank_params``), runs as
spawned gloo ranks (``torch_ranks.spawn``) at meshes (1, 2), (2, 1) and
(2, 2). Each rank encodes seeded images through its cut of the tower
(within 1e-5 of the JAX ``vision_encode``; at model 2 each rank holds the
rule table's blocks of ``vision.*``), then serves CAMD on ``paged_cuda``
with cross-modal rescoring over three image requests on two images,
drawing the reference's Gumbel noise. The JAX engine serves the same
requests on the same meshes of four forced host devices, in two
subprocesses started beside the ranks. Tokens, candidates, rounds,
admissions, image encodes and memo hits must be equal; each candidate's
``s_align_xmodal`` and score and each request's p* within 1e-5; the ranks
must agree with each other bit for bit. The rank cut of the tower, the
refusal of tower heads that do not split whole and of rescoring with a
rank model are checked in one process.
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
from repro.models import build_model as jbuild
from repro_torch.config import CAMDConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, rank_params
from repro_torch.core import rescore
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import build_model
from torch_ranks import _one_torch_thread  # noqa: F401
from torch_ranks import (ROOT, VLM_CAMD, VLM_ENGINE, FakeWorld,
                         config_fields, digest, port_config, spawn,
                         subprocess_env, vlm_digest, vlm_ranks,
                         vlm_requests)

MESHES = ((1, 2), (2, 1), (2, 2))
TOL = 1e-5

SNIPPET = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.config import CAMDConfig, PagedKVConfig, SamplingConfig
from repro.configs import get_config
from repro.launch.mesh import make_serve_mesh
from repro.models import build_model
from repro.serving import Request, ServeEngine
assert jax.device_count() == 4, jax.devices()
%s
%s
%s
engine_kw, camd_kw, meshes = json.loads(sys.argv[1])
cfg = get_config("llava_1_5_7b").reduced().with_overrides(dtype="float32")
model = build_model(cfg, jnp.float32)
params = model.init(jax.random.PRNGKey(0))
out = []
for dp, mp in meshes:
    eng = ServeEngine(model, params, impl="paged",
                      mesh=make_serve_mesh(dp, model=mp),
                      sampling=SamplingConfig(max_new_tokens=6,
                                              temperature=0.8),
                      camd=CAMDConfig(**camd_kw),
                      paged_kv=PagedKVConfig(page_size=8), **engine_kw)
    admitted = []
    admit = eng._admit
    def spy(req, slot_ids, limit=None, admit=admit):
        admitted.append([int(req.uid), [int(s) for s in slot_ids]])
        return admit(req, slot_ids, limit=limit)
    eng._admit = spy
    for req in vlm_requests(cfg, Request):
        eng.submit(req)
    res = eng.run()
    eng.pool.check()
    out.append([[dp, mp], {"admitted": admitted, "streams": vlm_digest(res),
                           "image_encodes": eng.image_encodes,
                           "image_feat_hits": eng.image_feat_hits,
                           "total_steps": eng.total_steps,
                           "host_syncs": eng.host_syncs}])
print(json.dumps(out))
""" % tuple(inspect.getsource(f) for f in (digest, vlm_digest, vlm_requests))


# the JAX engines in two subprocesses of about equal time (each mesh's
# engine compiles anew, 20-36 s alone): one would take the file past its
# 60 s
JAX_GROUPS = (((1, 2), (2, 1)), ((2, 2),))


def _jax_reference(meshes):
    """The JAX engine's records on ``meshes``, in a subprocess with four
    forced host devices and one XLA thread (started, not waited for)."""
    arg = json.dumps([VLM_ENGINE, VLM_CAMD, meshes])
    return subprocess.Popen([sys.executable, "-c", SNIPPET, arg], cwd=ROOT,
                            env=subprocess_env(4), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _jcfg():
    return jget_config("llava_1_5_7b").reduced().with_overrides(
        dtype="float32")


@pytest.fixture(scope="module")
def llava():
    """The reduced llava's JAX model and numpy weights, the port config
    and seeded images with the JAX tower's encode of them."""
    jcfg = _jcfg()
    jmodel = jbuild(jcfg, jnp.float32)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    v = jcfg.vision
    images = np.random.default_rng(4).standard_normal(
        (2, v.image_h, v.image_w, v.channels)).astype(np.float32)
    enc = np.asarray(jmodel.encode_image(np_params, jnp.asarray(images)))
    return jcfg, port_config(config_fields(jcfg)), np_params, images, enc


@pytest.fixture(scope="module")
def runs(llava, tmp_path_factory):
    """{mesh: (the ranks' records, the JAX engine's record)}, the JAX
    subprocesses running beside the port's ranks."""
    jcfg, _, np_params, images, _ = llava
    assert sorted(m for g in JAX_GROUPS for m in g) == sorted(MESHES)
    procs = [_jax_reference(group) for group in JAX_GROUPS]
    port = {}
    try:
        for dp, mp in MESHES:
            port[(dp, mp)] = spawn(vlm_ranks, dp * mp,
                                   tmp_path_factory.mktemp("vlm"), dp, mp,
                                   config_fields(jcfg), np_params, images)
    finally:
        outs = [(p, p.communicate(timeout=300)) for p in procs]
    ref = {}
    for p, (stdout, stderr) in outs:
        assert p.returncode == 0, stderr[-3000:]
        for mesh, rec in json.loads(stdout.strip().splitlines()[-1]):
            ref[tuple(mesh)] = rec
    return {mesh: (port[mesh], ref[mesh]) for mesh in MESHES}


def _ids(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _tokens(streams):
    floats = ("sum_lp", "score", "p_star", "best_score", "s_align_xmodal")
    return [{k: v for k, v in s.items() if k not in floats}
            for s in streams]


@pytest.mark.parametrize("mesh", [m for m in MESHES if m[1] > 1], ids=_ids)
def test_tower_over_model_ranks_matches_reference(llava, runs, mesh):
    """Every rank of a model group encodes the images within 1e-5 of the
    JAX tower, the ranks of a group bit for bit alike, and each holds the
    rule table's blocks of ``vision.*``: its heads' ``wq``/``wk``/``wv``
    columns and ``wo`` rows, ``patch_proj``, ``w_in`` and ``w_out``
    columns and ``out_proj`` rows; the position table and norms whole."""
    _, cfg, np_params, _, enc = llava
    full = params_from_jax(np_params, cfg)
    lmesh = make_local_mesh(mesh)
    specs = shd.serve_param_specs(cfg, full, lmesh)
    cuts = shd.cut_specs(specs)
    for name in ("vision.patch_proj.kernel", "vision.blocks.0.wq.kernel",
                 "vision.blocks.0.mlp.w_in.kernel",
                 "vision.blocks.0.mlp.w_out.kernel"):
        assert specs[name] == (None, "model"), name
    for name in ("vision.blocks.0.wo.kernel", "vision.out_proj.kernel"):
        assert specs[name] == ("model", None), name
    for name in ("vision.pos_emb", "vision.final_norm.scale"):
        assert specs[name] == (None,) * full[name].ndim, name
    port, _ = runs[mesh]
    for rank, rec in enumerate(port):
        np.testing.assert_allclose(rec["encode"], enc, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(rec["encode"], port[0]["encode"])
        d, m = divmod(rank, mesh[1])
        want = shd.place({k: v for k, v in full.items()
                          if k.startswith("vision.")}, cuts, lmesh,
                         dict(data=d, model=m))
        assert set(rec["vision"]) == set(want)
        for key, block in want.items():
            np.testing.assert_array_equal(rec["vision"][key], block.numpy(),
                                          err_msg=key)
        assert rec["vision"]["vision.blocks.0.wq.kernel"].shape[1] == \
            cfg.vision.d_model // mesh[1]


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
def test_vlm_rank_streams_equal_reference(runs, mesh):
    """Every rank's tokens, candidates, rounds and tokens spent, its
    admissions (request and slots), steps, host syncs, image encodes and
    feature-memo hits equal the JAX engine's on the same mesh."""
    port, ref = runs[mesh]
    assert (ref["image_encodes"], ref["image_feat_hits"]) == (2, 1)
    for rank, rec in enumerate(port):
        assert _tokens(rec["streams"]) == _tokens(ref["streams"]), rank
        assert rec["admitted"] == ref["admitted"], rank
        for key in ("image_encodes", "image_feat_hits", "total_steps",
                    "host_syncs"):
            assert rec[key] == ref[key], (rank, key)


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
def test_vlm_rank_scores_within_tolerance(runs, mesh):
    """Each candidate's cross-modal S_align and score, each request's p*
    within 1e-5 of the JAX engine's; every candidate was rescored."""
    port, ref = runs[mesh]
    for rec in port:
        for got, want in zip(rec["streams"], ref["streams"]):
            assert None not in got["s_align_xmodal"]
            assert None not in want["s_align_xmodal"]
            for key in ("s_align_xmodal", "score"):
                np.testing.assert_allclose(got[key], want[key], rtol=0,
                                           atol=TOL)
            assert abs(got["p_star"] - want["p_star"]) <= TOL


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
def test_vlm_ranks_agree(runs, mesh):
    """The ranks serve the same streams bit for bit and rescore the same
    candidates, every candidate the engine finished, each with rank 0's
    S_align already its own; a rank stages evidence rows for its own
    slots only; the pool ends empty."""
    port, _ = runs[mesh]
    n_cands = sum(len(s["candidates"]) for s in port[0]["streams"])
    for rec in port:
        assert rec["streams"] == port[0]["streams"]
        assert rec["rescored"] == n_cands and rec["parted"] == 0
        assert rec["evid_rows"] == VLM_ENGINE["slots"] // mesh[0]
        assert rec["pool"]["in_use"] == 0 and rec["reserved"] == 0


# ---------------------------------------------------------------------------
# in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [0, 1])
def test_rank_params_cut_the_tower_as_build_model(llava, rank):
    """``convert.rank_params`` cuts ``vision.*`` to the blocks a seeded
    ``build_model(..., world=)`` holds: the same shapes, and each the
    rule table's block of the whole tensor, as the seeded rank build's
    are of the seeded one-device model's, bit for bit."""
    _, cfg, np_params, _, _ = llava
    world = FakeWorld(1, 2, rank=rank)
    cuts = shd.cut_specs(shd.serve_param_specs(
        cfg, params_from_jax(np_params, cfg), world))
    at = dict(data=0, model=rank)
    got = rank_params(np_params, cfg, world)
    built = build_model(cfg, torch.float32, device="cpu", seed=0,
                        world=world).state_dict()
    seeded = build_model(cfg, torch.float32, device="cpu",
                         seed=0).state_dict()
    want = shd.place(params_from_jax(np_params, cfg), cuts, world, at)
    want_seeded = shd.place(seeded, cuts, world, at)
    vision = sorted(k for k in built if k.startswith("vision."))
    assert len(vision) == 4 + 8 * cfg.vision.num_layers
    for key in vision:
        assert got[key].shape == built[key].shape, key
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
        torch.testing.assert_close(built[key], want_seeded[key], rtol=0,
                                   atol=0)
    assert built["vision.blocks.0.wo.kernel"].shape[0] == \
        cfg.vision.d_model // 2


@pytest.mark.parametrize("name,model,ok", [
    ("llava-1.5-7b", 2, True), ("internvl2-2b", 2, True),
    ("internvl2-2b", 4, True), ("internvl2-2b", 8, False)])
def test_vision_heads_split_whole(name, model, ok):
    """The tower's heads must split whole over the model axis:
    internvl2-2b's 12 at model 8 raise NotImplementedError naming ROADMAP
    (its LM's 16/8 heads would split); llava's 16 and internvl2's 12 at
    model 2 and 4 split."""
    cfg = get_config(name)
    mesh = make_local_mesh((1, model))
    if ok:
        shd.check_model_split(cfg, mesh)
        return
    with pytest.raises(NotImplementedError, match="vision tower.*ROADMAP"):
        shd.check_model_split(cfg, mesh)


def test_rescoring_with_a_rank_model_raises(llava):
    """``core.rescore`` on a model cut for a rank is out of scope: it
    raises NotImplementedError naming ROADMAP before any forward."""
    _, cfg, _, _, _ = llava
    model = build_model(cfg, torch.float32, device="cpu",
                        world=FakeWorld(1, 2))
    toks = torch.zeros((2, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        rescore.camd_wrap(model, CAMDConfig(), toks[0], toks,
                          torch.ones(2, 4))
