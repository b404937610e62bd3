"""Serving over ranks against the JAX engine on the same meshes, on the CPU.

The port's engine runs as spawned gloo ranks (``torch_ranks.spawn``: a
``FileStore`` under ``tmp_path``, one thread a rank) at meshes (1, 2),
(2, 1) and (2, 2) of the golden harness's tiny model
(``tests/data/make_golden_fifo.py``: 4 heads over 2 kv heads, vocab 64),
each rank holding its blocks of the reference's weights
(``convert.rank_params``) and drawing the reference's Gumbel noise. The
JAX engine serves the same cases on the same meshes in subprocesses with
four forced host devices (one a mesh, all started before the port's
ranks). Cases: CAMD on ``paged`` with three candidates a round (a
round's candidates span both data shards, so a rank reads another
shard's prompt pages through its mirror pages), greedy on ``torch``, and
at (1, 2) CAMD on an int8 pool. Tokens, candidates, rounds, admissions,
scheduler and pool stats (per-shard counters included), steps and host
syncs must be equal; ``sum_lp``, ``score``, ``p_star`` and
``best_score`` within 1e-5. The serve CLI under ranks, the refusals and
the absence of fallbacks are checked too.
"""
import dataclasses
import inspect
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch import config as tconfig
from repro_torch.distributed import context
from repro_torch.launch import serve
from repro_torch.launch.mesh import ServeMesh
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.frontend import AsyncServeFrontend
from test_torch_engine_camd import _one_torch_thread  # noqa: F401
from test_torch_serving_sharded import model3, port_engine  # noqa: F401
from torch_ranks import (GOLDEN_CAMD, FakeWorld, cli_runs, digest,
                         serve_cases, spawn, subprocess_env)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((1, 2), (2, 1), (2, 2))
SPAN = dict(samples_per_round=3)           # a round spans both shards
CASES = {
    "camd_paged": (dict(mode="camd", impl="paged", macro_steps=8,
                        camd=SPAN), 3, 12),
    "greedy_torch": (dict(mode="greedy", impl="torch", macro_steps=8), 2, 5),
    "camd_int8": (dict(mode="camd", impl="paged", macro_steps=8, camd=SPAN,
                       paged_kv=dict(kv_dtype="int8")), 3, 12),
}
PER_MESH = {(1, 2): ("camd_paged", "greedy_torch", "camd_int8"),
            (2, 1): ("camd_paged", "greedy_torch"),
            (2, 2): ("camd_paged", "greedy_torch")}
GRID = [(mesh, case) for mesh in MESHES for case in PER_MESH[mesh]]
SCHED_KEYS = ("admitted_per_shard", "admitted_candidates", "spent",
              "declined_rounds")
FLOAT_TOL = 1e-5

SNIPPET = r"""
import importlib.util, json, os, sys
import jax, numpy as np
from repro.config import CAMDConfig, PagedKVConfig
from repro.launch.mesh import make_serve_mesh
spec = importlib.util.spec_from_file_location(
    "make_golden_fifo", os.path.join("tests", "data", "make_golden_fifo.py"))
gold = importlib.util.module_from_spec(spec)
spec.loader.exec_module(gold)
assert jax.device_count() == 4, jax.devices()
cfg, model, params = gold.tiny_model()
%s
golden_camd, runs = json.loads(sys.argv[1])
out = []
for (dp, mp), name, (kw, n, plen) in runs:
    kw = dict(kw, impl={"torch": "xla"}.get(kw["impl"], kw["impl"]))
    kw["paged_kv"] = PagedKVConfig(page_size=8, **kw.pop("paged_kv", {}))
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
    rec = {"admitted": admitted, "streams": digest(res),
           "sched": eng.sched_stats(), "host_syncs": eng.host_syncs,
           "total_steps": eng.total_steps}
    if eng.paged:
        eng.pool.check()
        rec["pool"] = eng.pool.stats()
    out.append([[dp, mp], name, rec])
print(json.dumps(out))
""" % inspect.getsource(digest)
# the JAX engines in three subprocesses of about equal compile time
JAX_GROUPS = ((((1, 2), "camd_paged"), ((1, 2), "greedy_torch"),
               ((2, 1), "greedy_torch")),
              (((1, 2), "camd_int8"), ((2, 1), "camd_paged")),
              (((2, 2), "camd_paged"), ((2, 2), "greedy_torch")))


def _jax_reference(group):
    """The JAX engine's records of a group's (mesh, case)s, in a
    subprocess with four forced host devices (started, not waited
    for)."""
    arg = json.dumps([GOLDEN_CAMD, [(mesh, case, CASES[case])
                                    for mesh, case in group]])
    return subprocess.Popen([sys.executable, "-c", SNIPPET, arg], cwd=ROOT,
                            env=subprocess_env(4), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(model3, tmp_path_factory):
    """{(mesh, case): (the port's records by rank, the JAX engine's
    record)}, the JAX subprocesses running beside the port's ranks."""
    jcfg, _, jparams, _ = model3
    assert sorted(k for g in JAX_GROUPS for k in g) == sorted(GRID)
    procs = [_jax_reference(group) for group in JAX_GROUPS]
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tconfig.ModelConfig)}
    params = jax.tree.map(np.asarray, jparams)
    port = {}
    try:
        for mesh in MESHES:
            cases = [(c,) + CASES[c] for c in PER_MESH[mesh]]
            port[mesh] = spawn(serve_cases, mesh[0] * mesh[1],
                               tmp_path_factory.mktemp("ranks"), mesh[0],
                               mesh[1], fields, params, cases)
    finally:
        outs = [(p, p.communicate(timeout=300)) for p in procs]
    ref = {}
    for p, (stdout, stderr) in outs:
        assert p.returncode == 0, stderr[-3000:]
        for mesh, case, rec in json.loads(stdout.strip().splitlines()[-1]):
            ref[(tuple(mesh), case)] = rec
    return {(mesh, case): ([r[case] for r in port[mesh]], ref[(mesh, case)])
            for mesh, case in GRID}


def _ids(p):
    return f"{p[0][0]}x{p[0][1]}-{p[1]}"


def _tokens(streams):
    """A digest without its floats: tokens, candidates, rounds, counts."""
    floats = ("sum_lp", "score", "p_star", "best_score")
    return [{k: v for k, v in s.items() if k not in floats}
            for s in streams]


@pytest.mark.parametrize("key", GRID, ids=[_ids(k) for k in GRID])
def test_rank_streams_equal_reference(runs, key):
    """Every rank's tokens, candidates, rounds and tokens spent equal the
    JAX engine's on the same mesh."""
    port, ref = runs[key]
    for rank, rec in enumerate(port):
        assert _tokens(rec["streams"]) == _tokens(ref["streams"]), \
            f"rank {rank} of {key}"


@pytest.mark.parametrize("key", GRID, ids=[_ids(k) for k in GRID])
def test_rank_admissions_and_stats_equal_reference(runs, key):
    """The same admissions in the same order (request and slots), the
    same scheduler counters (per shard too), steps and host syncs, and on
    paged cases the same pool stats, per-shard counters included."""
    port, ref = runs[key]
    for rec in port:
        assert rec["admitted"] == ref["admitted"]
        assert {k: rec["sched"].get(k) for k in SCHED_KEYS} == \
            {k: ref["sched"].get(k) for k in SCHED_KEYS}
        assert (rec["total_steps"], rec["host_syncs"]) == \
            (ref["total_steps"], ref["host_syncs"])
        if "pool" in ref:
            assert json.loads(json.dumps(rec["pool"])) == ref["pool"]
            assert rec["reserved"] == 0


@pytest.mark.parametrize("key", GRID, ids=[_ids(k) for k in GRID])
def test_rank_scores_within_tolerance(runs, key):
    """sum_lp and score of every candidate, p* and the best score of
    every request within 1e-5 of the JAX engine's."""
    port, ref = runs[key]
    for rec in port:
        for got, want in zip(rec["streams"], ref["streams"]):
            for k in ("sum_lp", "score"):
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=FLOAT_TOL)
            for k in ("p_star", "best_score"):
                assert abs(got[k] - want[k]) <= FLOAT_TOL, (k, got, want)


@pytest.mark.parametrize("key", GRID, ids=[_ids(k) for k in GRID])
def test_ranks_hold_their_blocks(runs, key):
    """Each rank holds its data shard's slot rows, its shard's page range
    (plus mirror pages past it when dp > 1) and its kv heads, runs its
    body eagerly on gloo, and every rank reports the same streams."""
    (dp, mp), case = key
    port, _ = runs[key]
    for rec in port:
        assert rec["B_local"] == 4 // dp
        assert rec["eager_body"] is True
        assert rec["streams"] == port[0]["streams"]
        if "pool" in rec:
            pages = rec["pool"]["num_pages"]
            assert rec["own_pages"] == pages // dp
            # mirrors: one prompt's full pages for each slot of the shard
            assert rec["pool_pages"] == pages // dp + \
                (4 // dp * (32 // 8 - 1) if dp > 1 else 0)
            assert rec["kv_heads"] == 2 // mp


def test_spanning_rounds_read_mirror_pages(runs):
    """At dp 2 a CAMD round of three candidates spans both shards: the
    ranks mirror the prompt pages their slots read on the other shard,
    and still serve the reference's streams."""
    for dp_mesh in ((2, 1), (2, 2)):
        port, _ = runs[(dp_mesh, "camd_paged")]
        assert max(rec["mirror_peak"] for rec in port) > 0, dp_mesh


# ---------------------------------------------------------------------------
# the serve CLI under ranks
# ---------------------------------------------------------------------------

CLI = ["--device", "cpu", "--requests", "3", "--max-new", "6",
       "--prompt-len", "20", "--num-layers", "1", "--impl", "paged_cuda",
       "--slots", "4", "--cache-len", "32", "--page-size", "8"]


def test_serve_cli_over_ranks_equals_one_process(tmp_path):
    """``serve.main`` on gloo ranks (``--mesh 1,2`` and ``--mesh 2,1``,
    ``--dist-backend gloo``; CAMD on the reduced qwen3, its kernels'
    plain versions) serves the streams of one process with as many
    logical data shards (``--serve-dp``; shard-local capacity binds on
    this pool, so dp 2 admits otherwise than dp 1); rank 0 prints the
    results, every rank its launches, and the mesh line says the body
    runs eagerly on gloo."""
    for mesh in ("1,2", "2,1"):
        with torch.inference_mode():
            one = serve.main(CLI + ["--serve-dp", mesh[0]])
        want = digest(one["results"])
        argv = CLI + ["--mesh", mesh, "--dist-backend", "gloo"]
        outs = spawn(cli_runs, 2, tmp_path / mesh.replace(",", "x"), [argv])
        for rank, ((text, streams, eager, launches),) in enumerate(outs):
            assert _tokens(streams) == _tokens(want), (mesh, rank)
            for got, exp in zip(streams, want):
                np.testing.assert_allclose(got["score"], exp["score"],
                                           rtol=0, atol=FLOAT_TOL)
            assert eager is True
            assert f"rank {rank} launches: " in text
            assert ("req 0:" in text) == (rank == 0)
            if rank == 0:
                assert "graph: off (gloo)" in text
            assert launches["paged_decode_attention"] == 0   # the CPU


# ---------------------------------------------------------------------------
# refusals and no fallback
# ---------------------------------------------------------------------------

def _rank_mesh(dp, mp):
    world = FakeWorld(dp, mp)
    return ServeMesh(dict(world.shape), world.axis_names,
                     (world.device,) * world.size, world)


@pytest.mark.parametrize("feature", [
    dict(spec_k=4), dict(prefix_cache=True), dict(prefill_chunk=16),
    dict(prefill_shards=1), dict(xmodal_rescore=True)],
    ids=["spec", "prefix_cache", "chunks", "prefill_shards", "xmodal"])
def test_features_over_ranks_raise(model3, feature):
    """Over more than one rank, speculation, the prefix cache, chunked
    prefill and prefill shards raise NotImplementedError naming ROADMAP;
    on one rank they stay. Cross-modal rescoring serves over ranks: a
    rescoring engine on the reduced llava builds over (2, 1), staging
    evidence rows for its own slots only."""
    if "xmodal_rescore" in feature:
        from repro_torch.configs import get_config
        from repro_torch.models.model import build_model
        cfg = get_config("llava-1.5-7b").reduced().with_overrides(
            dtype="float32")
        eng = ServeEngine(build_model(cfg, torch.float32, device="cpu"),
                          slots=4, cache_len=32, mode="camd", impl="paged",
                          paged_kv=tconfig.PagedKVConfig(page_size=8),
                          mesh=_rank_mesh(2, 1), **feature)
        assert eng.xmodal_rescore and eng.B_local == 2
        assert tuple(eng._evid.shape) == (2, cfg.num_evidence_tokens,
                                          cfg.d_model)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_engine(model3[3], mode="camd", impl="paged", macro_steps=8,
                    mesh=_rank_mesh(2, 1), **feature)
    if "prefill_shards" not in feature:
        port_engine(model3[3], mode="camd", impl="paged", macro_steps=8,
                    mesh=_rank_mesh(1, 1), **feature)


def test_frontend_over_ranks_raises(model3):
    eng = port_engine(model3[3], mode="greedy", impl="paged", macro_steps=4,
                      mesh=_rank_mesh(2, 1))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        AsyncServeFrontend(eng)


# the step of ROADMAP.md Queue 1 item 5 each refused family waits for
REFUSED_STEP = {"seamless-m4t-large-v2": 4}


@pytest.mark.parametrize("arch", [
    "llava-1.5-7b", "granite-moe-3b-a800m", "mamba2-780m",
    "recurrentgemma-2b", "seamless-m4t-large-v2"])
def test_families_not_placed_raise(arch):
    """Encoder-decoder models are not cut for ranks: NotImplementedError
    naming their step of ROADMAP's item 5, before any weight is drawn.
    Recurrent and hybrid models are: the reduced mamba2 and recurrentgemma
    cut for model rank 1 of (1, 2) hold their blocks of the seeded
    one-device model (8 of 16 SSD heads with B and C whole, 128 of 256
    RG-LRU channels, 2 of 4 query heads beside the one kv head), their
    blocks and row-parallel projections wired to the world. The vlm
    family is: the reduced llava cut
    for model rank 0 of (1, 2) holds half of each tower block's heads,
    its row-parallel projections sum and its other column cuts gather
    over the model group. So is the MoE family: the reduced granite cut
    for rank (1, 1) of (2, 2) holds experts 2-3 at f 64 of 128, every
    block a slice of the seeded one-device model's, and its MoE layers
    take the world."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(arch).reduced().with_overrides(dtype="float32")
    if cfg.moe is not None:
        world = FakeWorld(2, 2, rank=3)
        rank = build_model(cfg, torch.float32, device="cpu", seed=0,
                           world=world)
        whole = build_model(cfg, torch.float32, device="cpu", seed=0)
        for got, want in zip(rank.layers, whole.layers):
            moe, ref = got.moe, want.moe
            assert moe.world is world
            assert tuple(moe.w_gate.shape) == (2, cfg.d_model, 64)
            for name in ("w_gate", "w_up"):
                assert torch.equal(getattr(moe, name),
                                   getattr(ref, name)[2:4, :, 64:])
            assert torch.equal(moe.w_down, ref.w_down[2:4, 64:])
            assert torch.equal(moe.router.kernel, ref.router.kernel)
            assert torch.equal(got.attn.wq.kernel,
                               want.attn.wq.kernel[:, cfg.d_model // 2:])
        return
    if cfg.ssm is not None or cfg.rglru is not None:
        world = FakeWorld(1, 2, rank=1)
        rank = build_model(cfg, torch.float32, device="cpu", seed=0,
                           world=world)
        whole = build_model(cfg, torch.float32, device="cpu", seed=0)
        for got, want in zip(rank.layers, whole.layers):
            if got.kind == "ssm":
                k, ref = got.ssm.in_proj.kernel, want.ssm.in_proj.kernel
                assert got.ssm.world is world
                assert got.ssm.out_proj.reduce_world is world
                assert torch.equal(k, torch.cat(
                    [ref[:, 256:512], ref[:, 768:1024], ref[:, 1024:1056],
                     ref[:, 1064:1072]], dim=1))
                assert torch.equal(got.ssm.A_log, want.ssm.A_log[8:])
            elif got.kind == "rglru":
                assert got.rglru.world is world
                assert got.rglru.out_proj.reduce_world is world
                assert torch.equal(got.rglru.lam, want.rglru.lam[128:])
                assert torch.equal(got.rglru.w_a.kernel,
                                   want.rglru.w_a.kernel[:, 128:])
            else:
                assert torch.equal(got.attn.wk.kernel, want.attn.wk.kernel)
                assert torch.equal(got.attn.wq.kernel,
                                   want.attn.wq.kernel[:, 128:])
                assert got.attn.wo.reduce_world is world
            if got.mlp is not None:
                assert got.mlp.w_out.reduce_world is world
                assert torch.equal(got.mlp.w_out.kernel,
                                   want.mlp.w_out.kernel[256:])
        assert rank.kv_heads == (1 if cfg.num_kv_heads else 0)
        return
    if cfg.vision is not None:
        world = FakeWorld(1, 2)
        tower = build_model(cfg, torch.float32, device="cpu",
                            world=world).vision
        d = cfg.vision.d_model
        for blk in tower.blocks:
            for proj in (blk.wq, blk.wk, blk.wv):
                assert tuple(proj.kernel.shape) == (d, d // 2)
                assert proj.gather_world is proj.reduce_world is None
            assert tuple(blk.wo.kernel.shape) == (d // 2, d)
            assert blk.wo.reduce_world is world
            assert blk.mlp.w_in.gather_world is world
            assert blk.mlp.w_out.gather_world is world
        assert tower.patch_proj.gather_world is world
        assert tower.out_proj.reduce_world is world
        assert tuple(tower.out_proj.kernel.shape) == (d // 2, cfg.d_model)
        return
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md Queue 1 item 5, step "
                       f"{REFUSED_STEP[arch]}"):
        build_model(cfg, torch.float32, device="cpu", world=FakeWorld(1, 2))


def test_uncut_model_on_a_model_axis_raises(model3):
    with pytest.raises(ValueError, match="cut for the rank"):
        port_engine(model3[3], mode="camd", impl="paged", macro_steps=8,
                    mesh=_rank_mesh(1, 2))


def test_no_hidden_fallback(monkeypatch):
    """Ranks without a GPU need device='cpu'; gloo runs only when named
    (the CLI refuses NCCL ranks on the CPU rather than switching); a
    rank world needs a process group."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            context._device_for("gloo", None)
        with pytest.raises(RuntimeError, match="gloo"):
            context._device_for("nccl", None)
    with pytest.raises(RuntimeError, match="process group"):
        context.init_rank_world(1, 1, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(SystemExit, match="gloo"):
        serve.main(["--device", "cpu", "--mesh", "1,1"])
    with pytest.raises(SystemExit, match="--mesh"):
        serve.main(["--device", "cpu", "--dist-backend", "gloo"])
    assert not torch.distributed.is_initialized()
    assert context.get_world() is None
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(SystemExit, match="torchrun"):
        serve.main(["--device", "cpu", "--dist-backend", "gloo"])


def test_one_process_engine_is_unchanged_by_rank_plumbing(model3):
    """Without a rank world the engine holds every row and page, keeps no
    mirror and gathers nothing."""
    eng = port_engine(model3[3], mode="camd", impl="paged", macro_steps=8,
                      dp=2)
    assert eng.world is None and eng.B_local == eng.B == 4
    assert eng.state.cache["k_pages"].shape[1] == eng.pool.num_pages
    assert not eng._mirror_free and eng._eager_body is False
    t = torch.arange(4)
    assert eng._all_rows(t) is t
    assert isinstance(eng, ServeEngine)
