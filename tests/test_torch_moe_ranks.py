"""MoE over ranks against the JAX package, on the CPU.

The reduced granite-moe-3b-a800m (2 layers, d 256, 4/2 heads, 4 experts
top-2 of width f 128, vocabulary 512) with the reference's weights runs
as spawned gloo ranks (``torch_ranks.spawn``), each rank holding its
blocks (``convert.rank_params``): at (1, 2) every rank holds the 4
experts at f 64, at (2, 1) all 4 whole, at (2, 2) 2 experts at f 64.
One spawn of two ranks serves (1, 2) and (2, 1), one of four ranks
(2, 2) and the expert-parallel function; the JAX references run in two
subprocesses on four forced host devices, started beside the ranks.

- ``moe_apply`` on every rank against the reference's ``moe_apply`` on
  the global batch, in both row layouts: rows every data rank holds alike
  (prefill) and each data rank's block of the rows (decode); also with a
  shared expert, cut as the dense gated MLP. Output rows
  and aux within 1e-5, the dropped share equal. One decode case of 16
  global rows at capacity factor 1.0 drops pairs in the reference, where
  groups formed from a data rank's own 8 rows would drop none; one cuts
  the gathered rows into groups of 6 (a padded last group).
- ``moe_apply_sparse`` against the reference's where nothing drops, and
  under a binding capacity against a numpy statement of the sort/scatter
  MoE with dropped pairs kept out of the slots (the reference's R3
  scatter can overwrite slot 0 there).
- ``moe_apply_shard_map`` on four ranks at (4, 1) and (2, 2) (``f`` cut
  on the model axis), with a shared expert as in
  ``tests/test_moe_shard_map.py``, against the reference's function on
  the same meshes and against ``moe_apply_dense``, within 3e-4.
- Served streams: CAMD on ``paged`` with three candidates a round (a
  round spans both data shards) and greedy on ``torch`` at (1, 2),
  (2, 1) and (2, 2), and the legacy loop (K 0) with CAMD at (2, 1),
  against the JAX engine on the same meshes: tokens, candidates,
  rounds, admissions, steps and host syncs equal; sum_lp, score, p* and
  the best score within 1e-5.
"""
import dataclasses
import inspect
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ATTN as JATTN
from repro.config import ModelConfig as JModelConfig
from repro.config import MoEConfig as JMoEConfig
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro_torch.convert import flat_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models.moe_shard_map import moe_apply_shard_map
from torch_ranks import _one_torch_thread  # noqa: F401
from torch_ranks import (GOLDEN_CAMD, ROOT, FakeWorld, config_fields,
                         digest, moe_ranks, port_config, spawn,
                         subprocess_env)

TOL = 1e-5
SHARD_MAP_TOL = 3e-4                    # tests/test_moe_shard_map.py's
D = 256
UNIT_SEED = 21
# (name, global rows, split over the data ranks, MoE overrides)
UNIT_CASES = (("prefill", (2, 12), False, {}),
              ("decode", (8,), True, {}),
              ("decode drops", (16,), True, dict(capacity_factor=1.0)),
              ("decode groups of 6", (16,), True,
               dict(capacity_factor=1.0, group_size=6)),
              ("prefill drops", (3, 16), False,
               dict(capacity_factor=1.0, group_size=16)))
SPAN = dict(samples_per_round=3)           # a round spans both shards
CASES = {
    "camd_paged": (dict(mode="camd", impl="paged", macro_steps=8,
                        camd=SPAN), 3, 12),
    "greedy_torch": (dict(mode="greedy", impl="torch", macro_steps=8), 2, 5),
    "camd_legacy": (dict(mode="camd", impl="paged", macro_steps=0,
                         camd=SPAN), 3, 12),
}
PER_MESH = {(1, 2): ("camd_paged", "greedy_torch"),
            (2, 1): ("camd_paged", "greedy_torch", "camd_legacy"),
            (2, 2): ("camd_paged", "greedy_torch")}
GRID = [(mesh, case) for mesh in PER_MESH for case in PER_MESH[mesh]]
SHARD_MAP_MESHES = ((4, 1, False), (2, 2, True))

# the shard_map config of tests/test_moe_shard_map.py, as JSON for the
# subprocess
SM_KW = dict(name="t", family="moe", num_layers=1, d_model=32, num_heads=2,
             num_kv_heads=1, d_ff=48, vocab_size=64, head_dim=32,
             mlp_activation="swiglu", dtype="float32")
SM_MOE = dict(num_experts=8, top_k=2, expert_d_ff=48, num_shared_experts=1,
              capacity_factor=8.0)
SM_CFG = JModelConfig(**SM_KW, block_pattern=(JATTN,),
                      moe=JMoEConfig(**SM_MOE))

SNIPPET = r"""
import dataclasses, importlib.util, json, os, sys
import jax, jax.numpy as jnp, numpy as np
from repro.config import ATTN as JATTN, CAMDConfig, ModelConfig as JModelConfig
from repro.config import MoEConfig as JMoEConfig, PagedKVConfig
from repro.configs import get_config
from repro.launch.mesh import make_local_mesh, make_serve_mesh
from repro.models import build_model
from repro.models.moe import moe_apply, moe_init
from repro.models.moe_shard_map import moe_apply_shard_map
spec = importlib.util.spec_from_file_location(
    "make_golden_fifo", os.path.join("tests", "data", "make_golden_fifo.py"))
gold = importlib.util.module_from_spec(spec)
spec.loader.exec_module(gold)
assert jax.device_count() == 4, jax.devices()
%s
golden_camd, (sm_kw, sm_moe, shard_maps), units, runs = json.loads(
    sys.argv[1])
out = {"shard_map": [], "units": {}, "serve": []}
if shard_maps:
    SM_CFG = JModelConfig(**sm_kw, block_pattern=(JATTN,),
                          moe=JMoEConfig(**sm_moe))
    params = moe_init(jax.random.PRNGKey(0), SM_CFG, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (64, 32))
    for dp, mp, model_axis in shard_maps:
        mesh = make_local_mesh((dp, mp), ("data", "model"))
        with mesh:
            y, aux = jax.jit(lambda p, x: moe_apply_shard_map(
                p, SM_CFG, x, mesh,
                model_axis="model" if model_axis else None))(params, x)
        out["shard_map"].append([[dp, mp], np.asarray(y).tolist(),
                                 {k: float(v) for k, v in aux.items()}])
cfg = get_config("granite-moe-3b-a800m").reduced().with_overrides(
    dtype="float32")
model = build_model(cfg, jnp.float32)
params = model.init(jax.random.PRNGKey(0))
# moe_apply on the unit cases' global inputs (and on each half of the
# rows where asked), layer 0's MoE
layer0 = jax.tree.map(lambda a: a[0], params["super"][0]["moe"])
rng = np.random.default_rng(units["seed"]) if units else None
for name, shape, over, halves in units["cases"] if units else ():
    x = rng.standard_normal(shape).astype(np.float32)
    c = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **over))
    parts = [x] + (np.split(x, 2) if halves else [])
    fn = jax.jit(moe_apply, static_argnums=1)
    res = [fn(layer0, c, jnp.asarray(part)) for part in parts]
    out["units"][name] = [[np.asarray(y).tolist(),
                           {k: float(v) for k, v in aux.items()}]
                          for y, aux in res]
for (dp, mp), name, (kw, n, plen) in runs:
    kw = dict(kw, impl={"torch": "xla"}.get(kw["impl"], kw["impl"]))
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
    rec = {"admitted": admitted, "streams": digest(res),
           "host_syncs": eng.host_syncs, "total_steps": eng.total_steps}
    if eng.paged:
        eng.pool.check()
        rec["pool"] = eng.pool.stats()
    out["serve"].append([[dp, mp], name, rec])
print(json.dumps(out))
""" % inspect.getsource(digest)
# the JAX references in two subprocesses of about equal time
JAX_GROUPS = ((True, (((2, 2), "camd_paged"), ((2, 2), "greedy_torch"),
                      ((1, 2), "greedy_torch"))),
              (False, (((1, 2), "camd_paged"), ((2, 1), "camd_paged"),
                       ((2, 1), "greedy_torch"), ((2, 1), "camd_legacy"))))


def _jax_reference(first, group):
    """The JAX references in a subprocess with four forced host devices
    (started, not waited for): the engine's records of a group's (mesh,
    case)s and, in the ``first`` group, the shard_map outputs on
    ``SHARD_MAP_MESHES`` and ``moe_apply`` on the unit cases."""
    units = dict(seed=UNIT_SEED, cases=[
        (name, shape + (D,), over, name == "decode drops")
        for name, shape, _, over in UNIT_CASES]) if first else None
    arg = json.dumps([GOLDEN_CAMD,
                      (SM_KW, SM_MOE, SHARD_MAP_MESHES if first else []),
                      units,
                      [(mesh, case, CASES[case]) for mesh, case in group]])
    return subprocess.Popen([sys.executable, "-c", SNIPPET, arg], cwd=ROOT,
                            env=subprocess_env(4), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _granite_jcfg(**moe):
    jcfg = jget_config("granite-moe-3b-a800m").reduced().with_overrides(
        dtype="float32")
    return jcfg.with_overrides(moe=dataclasses.replace(jcfg.moe, **moe))


def _layer0_moe(flat):
    """The reference's MoE param dict of layer 0, from the flat tree."""
    pre = "layers.0.moe."
    return {"router": {"kernel": flat[pre + "router.kernel"]},
            **{k: flat[pre + k] for k in ("w_gate", "w_up", "w_down")}}


@pytest.fixture(scope="module")
def granite():
    """The reduced granite's JAX config, numpy weights, the port config,
    layer 0's MoE params (numpy) and the unit cases' global inputs."""
    jcfg = _granite_jcfg()
    np_params = jax.tree.map(np.asarray, jbuild(jcfg, jnp.float32).init(
        jax.random.PRNGKey(0)))
    cfg = port_config(config_fields(jcfg))
    rng = np.random.default_rng(UNIT_SEED)       # as the subprocess draws
    inputs = {name: rng.standard_normal(shape + (D,)).astype(np.float32)
              for name, shape, _, _ in UNIT_CASES}
    return jcfg, np_params, cfg, _layer0_moe(flat_from_jax(np_params, cfg)), \
        inputs


@pytest.fixture(scope="module")
def shard_map_setup():
    """``SM_CFG``'s reference params (numpy) and inputs, and the dense
    oracle's output."""
    params = jmoe.moe_init(jax.random.PRNGKey(0), SM_CFG, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (64, 32))
    dense = np.asarray(jmoe.moe_apply_dense(params, SM_CFG, x))
    return jax.tree.map(np.asarray, params), np.asarray(x), dense


@pytest.fixture(scope="module")
def runs(granite, shard_map_setup, tmp_path_factory):
    """The two spawns' records by rank and the JAX subprocesses' records,
    the subprocesses running beside the ranks."""
    jcfg, np_params, _, _, inputs = granite
    assert sorted(k for _, g in JAX_GROUPS for k in g) == sorted(GRID)
    procs = [_jax_reference(sm, group) for sm, group in JAX_GROUPS]
    fields = config_fields(jcfg)
    cases = [(name, inputs[name], split, over)
             for name, _, split, over in UNIT_CASES]

    def serves(meshes):
        return fields, np_params, [
            (mesh, [(c,) + CASES[c] for c in PER_MESH[mesh]])
            for mesh in meshes]
    sm_params, x, _ = shard_map_setup
    try:
        two = spawn(moe_ranks, 2, tmp_path_factory.mktemp("moe2"),
                    (fields, np_params, ((1, 2), (2, 1)), cases), None,
                    serves(((1, 2), (2, 1))))
        four = spawn(moe_ranks, 4, tmp_path_factory.mktemp("moe4"),
                     (fields, np_params, ((2, 2),), cases),
                     (config_fields(SM_CFG), sm_params, x, SHARD_MAP_MESHES),
                     serves(((2, 2),)))
    finally:
        outs = [(p, p.communicate(timeout=300)) for p in procs]
    ref = {"shard_map": {}, "serve": {}, "units": {}}
    for p, (stdout, stderr) in outs:
        assert p.returncode == 0, stderr[-3000:]
        got = json.loads(stdout.strip().splitlines()[-1])
        for name, parts in got["units"].items():
            ref["units"][name] = [(np.asarray(y, np.float32), aux)
                                  for y, aux in parts]
        for mesh, y, aux in got["shard_map"]:
            ref["shard_map"][tuple(mesh)] = (np.asarray(y, np.float32), aux)
        for mesh, case, rec in got["serve"]:
            ref["serve"][(tuple(mesh), case)] = rec
    return {"two": two, "four": four, "ref": ref}


def _ranks_of(runs, mesh):
    return runs["two"] if mesh[0] * mesh[1] == 2 else runs["four"]


def _ids(p):
    return f"{p[0]}x{p[1]}"


# ---------------------------------------------------------------------------
# moe_apply on a rank world
# ---------------------------------------------------------------------------

UNIT_MESHES = ((1, 2), (2, 1), (2, 2))


@pytest.mark.parametrize("case", UNIT_CASES, ids=[c[0] for c in UNIT_CASES])
@pytest.mark.parametrize("mesh", UNIT_MESHES, ids=_ids)
def test_rank_moe_apply_matches_reference(granite, runs, mesh, case):
    """Every rank's rows of the layer's output within 1e-5 of the
    reference's ``moe_apply`` on the global batch, its router losses
    within 1e-5 and its dropped share equal; the drop cases do drop."""
    name, _, split, over = case
    x = granite[4][name]
    want, aux = runs["ref"]["units"][name][0]
    if "drops" in name:
        assert aux["moe_drop_frac"] > 0, name
    dp = mesh[0]
    for rank, rec in enumerate(_ranks_of(runs, mesh)):
        got, got_aux = rec["units"][mesh][name]
        rows = want
        if split:
            n = x.shape[0] // dp
            d = rank // mesh[1]
            rows = want[d * n:(d + 1) * n]
        np.testing.assert_allclose(got, rows, rtol=TOL, atol=TOL,
                                   err_msg=f"rank {rank}")
        for k in ("moe_lb_loss", "moe_z_loss"):
            assert abs(got_aux[k] - aux[k]) <= TOL, (k, rank)
        assert got_aux["moe_drop_frac"] == pytest.approx(
            aux["moe_drop_frac"], abs=1e-7)


@pytest.mark.parametrize("mesh", UNIT_MESHES, ids=_ids)
def test_ranks_hold_their_experts(runs, mesh):
    """The rule table's cut: (1, 2) all 4 experts at f 64, (2, 1) all 4
    whole, (2, 2) the data rank's 2 experts at f 64."""
    dp, mp = mesh
    for rec in _ranks_of(runs, mesh):
        units = rec["units"][mesh]
        E_loc = 4 // dp if mp > 1 else 4
        assert units["experts"] == [E_loc, D, 128 // mp]
        assert units["w_down"] == [E_loc, 128 // mp, D]


@pytest.mark.parametrize("mesh", UNIT_MESHES, ids=_ids)
def test_rank_shared_expert_matches_reference(granite, runs, mesh):
    """A shared expert (as kimi-k2's) on the seeded reduced granite, its
    MLP cut as the dense gated one (gate and up columns, down rows summed
    over the model group): every rank's rows in both layouts within 1e-5
    of the reference's ``moe_apply`` on the one-device weights."""
    from repro_torch.models.model import build_model
    _, _, cfg, _, inputs = granite
    over = next(c for c in UNIT_CASES if c[0] == "decode drops")[3]
    c = cfg.with_overrides(moe=dataclasses.replace(
        cfg.moe, num_shared_experts=1, **over))
    p = build_model(c, torch.float32, device="cpu", seed=0).layers[0].moe
    jp = {"router": {"kernel": p.router.kernel.numpy()},
          **{k: getattr(p, k).numpy() for k in ("w_gate", "w_up", "w_down")},
          "shared": {k: {"kernel": getattr(p.shared, k).kernel.numpy()}
                     for k in ("w_gate", "w_up", "w_down")}}
    x = inputs["decode drops"]
    want = np.asarray(jmoe.moe_apply(
        jax.tree.map(jnp.asarray, jp),
        _granite_jcfg(num_shared_experts=1, **over), jnp.asarray(x))[0])
    dp, mp = mesh
    n = x.shape[0] // dp
    for rank, rec in enumerate(_ranks_of(runs, mesh)):
        gate, whole, rows = rec["units"][mesh]["shared"]
        assert gate == [D, 128 // mp]
        d = rank // mp
        np.testing.assert_allclose(whole, want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(rows, want[d * n:(d + 1) * n], rtol=TOL,
                                   atol=TOL)


def test_rank_local_groups_would_drop_otherwise(runs):
    """The decode drop case parts from groups a data rank forms from its
    own rows: the reference's ``moe_apply`` on each data half alone (the
    shortcut the rank path does not take) drops nothing and gives other
    outputs than on the global groups, which the ranks match."""
    (whole, aux), *halves = runs["ref"]["units"]["decode drops"]
    assert aux["moe_drop_frac"] > 0
    assert all(a["moe_drop_frac"] == 0 for _, a in halves)
    assert np.abs(np.concatenate([y for y, _ in halves]) - whole).max() > 1e-3


# ---------------------------------------------------------------------------
# moe_apply_sparse
# ---------------------------------------------------------------------------

def _port_moe(cfg, jp):
    p = tmoe.MoE(cfg, device="cpu")
    p.router.kernel.data = torch.from_numpy(np.array(jp["router"]["kernel"]))
    for k in ("w_gate", "w_up", "w_down"):
        getattr(p, k).data = torch.from_numpy(np.array(jp[k]))
    if "shared" in jp:
        for k in ("w_gate", "w_up", "w_down"):
            getattr(p.shared, k).kernel.data = torch.from_numpy(
                np.array(jp["shared"][k]["kernel"]))
    return p


def _sparse_statement(jp, x, k, C):
    """The sort/scatter MoE in numpy: fp64 router, the top-k gates
    renormalised, an expert's slots to its (token, choice) pairs in
    token-major order up to C, dropped pairs adding nothing. Returns
    (out, kept share)."""
    f64 = {n: np.asarray(v, np.float64) for n, v in
           (("r", jp["router"]["kernel"]), ("g", jp["w_gate"]),
            ("u", jp["w_up"]), ("d", jp["w_down"]))}
    x = x.astype(np.float64)
    logits = x @ f64["r"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    gates = np.take_along_axis(probs, idx, -1)
    gates /= gates.sum(-1, keepdims=True)
    count = np.zeros(probs.shape[1], int)
    out = np.zeros_like(x)
    kept = 0
    for t in range(x.shape[0]):
        for j in range(k):
            e = idx[t, j]
            if count[e] >= C:
                continue
            count[e] += 1
            kept += 1
            a = x[t] @ f64["g"][e]
            h = a / (1 + np.exp(-a)) * (x[t] @ f64["u"][e])
            out[t] += gates[t, j] * (h @ f64["d"][e])
    return out, kept / (x.shape[0] * k)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_sparse_matches_reference_without_drops(granite, impl):
    """Capacity factor 8: nothing drops; the port's ``moe_apply_sparse``
    within 1e-5 of the reference's (output and aux) and of
    ``moe_apply_dense``."""
    _, _, cfg, jp, inputs = granite
    x = inputs["prefill drops"].reshape(-1, D)
    want, aux = jmoe.moe_apply_sparse(jax.tree.map(jnp.asarray, jp),
                                      _granite_jcfg(), jnp.asarray(x),
                                      capacity_factor=8.0)
    p = _port_moe(cfg, jp)
    got, got_aux = tmoe.moe_apply_sparse(p, cfg, torch.from_numpy(x),
                                         capacity_factor=8.0, impl=impl)
    assert float(aux["moe_drop_frac"]) == 0.0 == float(got_aux[
        "moe_drop_frac"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    for k in ("moe_lb_loss", "moe_z_loss"):
        assert abs(float(got_aux[k]) - float(aux[k])) <= TOL, k
    np.testing.assert_allclose(
        got.numpy(), tmoe.moe_apply_dense(p, cfg, torch.from_numpy(x))
        .numpy(), rtol=TOL, atol=TOL)


def test_sparse_drops_leave_kept_rows_whole(granite):
    """Capacity binds (C 8 for 48 tokens' 96 pairs on 4 experts): kept
    pairs go through their expert, dropped ones add nothing, as the numpy
    statement says, within 1e-5. The reference differs from it where a
    dropped pair's zero row overwrote slot 0's kept row (R3), so it is
    not held here beyond the dropped share."""
    _, _, cfg, jp, inputs = granite
    x = inputs["prefill drops"].reshape(-1, D)
    cf = 0.25                               # C = max(8, 48 * 2 / 4 / 4)
    p = _port_moe(cfg, jp)
    want, kept = _sparse_statement(jp, x, 2, 8)
    got, aux = tmoe.moe_apply_sparse(p, cfg, torch.from_numpy(x),
                                     capacity_factor=cf, impl="cuda")
    assert 0 < kept < 1
    assert float(aux["moe_drop_frac"]) == pytest.approx(1 - kept, abs=1e-7)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    _, jaux = jmoe.moe_apply_sparse(jax.tree.map(jnp.asarray, jp),
                                    _granite_jcfg(), jnp.asarray(x),
                                    capacity_factor=cf)
    assert float(jaux["moe_drop_frac"]) == pytest.approx(1 - kept, abs=1e-7)


# ---------------------------------------------------------------------------
# moe_apply_shard_map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [m[:2] for m in SHARD_MAP_MESHES], ids=_ids)
def test_shard_map_matches_reference(runs, shard_map_setup, mesh):
    """Every rank's rows within 3e-4 of the reference's
    ``moe_apply_shard_map`` on the same mesh and of ``moe_apply_dense``;
    the aux within 1e-5 of the reference's and equal on every rank;
    nothing drops."""
    _, x, dense = shard_map_setup
    want, aux = runs["ref"]["shard_map"][mesh]
    dp = mesh[0]
    n = x.shape[0] // dp
    for rank, rec in enumerate(runs["four"]):
        got, got_aux = rec["shard_map"][mesh]
        d = rank // mesh[1]
        for exp in (want, dense):
            np.testing.assert_allclose(got, exp[d * n:(d + 1) * n],
                                       rtol=SHARD_MAP_TOL,
                                       atol=SHARD_MAP_TOL)
        assert got_aux == runs["four"][0]["shard_map"][mesh][1]
        for k, v in aux.items():
            assert abs(got_aux[k] - v) <= TOL, k
        assert got_aux["moe_drop_frac"] == 0.0


def test_shard_map_refuses_experts_that_do_not_split():
    """E = 8 over 3 data ranks: ``moe_apply_shard_map`` refuses before
    any collective."""
    cfg = port_config(config_fields(SM_CFG))
    p = tmoe.MoE(cfg, device="cpu")
    with pytest.raises(ValueError, match="do not split over 3 data ranks"):
        moe_apply_shard_map(p, cfg, torch.zeros(4, 32), FakeWorld(3, 1))


# ---------------------------------------------------------------------------
# served streams
# ---------------------------------------------------------------------------

def _grid_ids(k):
    return f"{k[0][0]}x{k[0][1]}-{k[1]}"


def _tokens(streams):
    floats = ("sum_lp", "score", "p_star", "best_score")
    return [{k: v for k, v in s.items() if k not in floats}
            for s in streams]


@pytest.mark.parametrize("key", GRID, ids=[_grid_ids(k) for k in GRID])
def test_moe_rank_streams_equal_reference(runs, key):
    """Every rank's tokens, candidates, rounds, admissions, steps and
    host syncs (and on paged cases pool stats) equal the JAX engine's on
    the same mesh; sum_lp, score, p* and the best score within 1e-5; the
    ranks' streams alike and each holding its experts."""
    mesh, case = key
    ref = runs["ref"]["serve"][key]
    recs = [r["serve"][mesh][case] for r in _ranks_of(runs, mesh)]
    for rank, rec in enumerate(recs):
        assert _tokens(rec["streams"]) == _tokens(ref["streams"]), rank
        assert rec["admitted"] == ref["admitted"]
        assert (rec["total_steps"], rec["host_syncs"]) == \
            (ref["total_steps"], ref["host_syncs"])
        if "pool" in ref:
            assert json.loads(json.dumps(rec["pool"])) == ref["pool"]
        for got, want in zip(rec["streams"], ref["streams"]):
            for k in ("sum_lp", "score"):
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL)
            for k in ("p_star", "best_score"):
                assert abs(got[k] - want[k]) <= TOL, (k, got, want)
        assert rec["streams"] == recs[0]["streams"]
        assert rec["B_local"] == 4 // mesh[0]
        assert rec["experts"][0] == (4 // mesh[0] if mesh[1] > 1 else 4)


# ---------------------------------------------------------------------------
# what a rank build refuses and how it cuts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("experts,f,world,refused", [
    (3, 128, FakeWorld(2, 2, rank=3), False),
    (4, 129, FakeWorld(1, 2), True),
    (4, 128, FakeWorld(4, 1, rank=1), False)],
    ids=["E3-over-dp2", "f129-over-model2", "E4-over-dp4-model1"])
def test_rank_build_cuts_or_refuses_experts(experts, f, world, refused):
    """The rule table's cut or the port's refusal: 3 experts at (2, 2) do
    not divide over the data axis, so every rank holds all 3 (f cut); an
    ``f`` of 129 does not divide over model 2: ``check_model_split``
    refuses it (NotImplementedError naming ROADMAP); at model 1 the
    serving specs replicate the experts on every data rank."""
    from repro_torch.models.model import build_model
    jcfg = _granite_jcfg(num_experts=experts, expert_d_ff=f)
    cfg = port_config(config_fields(jcfg))
    if refused:
        with pytest.raises(NotImplementedError,
                           match="hidden width 129.*ROADMAP.md"):
            build_model(cfg, torch.float32, device="cpu", world=world)
        return
    moe = build_model(cfg, torch.float32, device="cpu",
                      world=world).layers[0].moe
    assert tuple(moe.w_gate.shape) == (experts, D, f // world.model)
    assert tmoe.expert_range(moe, cfg, world) == (0, experts)
