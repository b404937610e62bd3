"""Spawned gloo ranks on the CPU for the rank tests (not a test module).

``spawn(fn, n, tmp_path, *args)`` runs ``fn(*args)`` in ``n`` fresh
processes joined in one gloo group through a ``FileStore`` under
``tmp_path`` (no TCP port, so parallel test workers cannot clash), each
on one torch thread and one BLAS thread, and returns the results by
rank; a failure in any rank raises here with its traceback. The rank
functions live in this module, which imports neither jax nor the JAX
package at import time: ``RankNoise`` draws the reference engine's
Gumbel noise (``test_torch_engine_camd.ReferenceNoise``) with jax
imported on first use, so that only ranks that sample pay for it.

The module also holds what every port test module shares to keep the
test workers off each other's cores: the session fixture
``_one_torch_thread`` (one torch and one BLAS thread) and
``subprocess_env`` (one OpenMP and one XLA thread in a subprocess, and
forced XLA host devices in it only).
"""
from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPAWN_TIMEOUT = 180
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def subprocess_env(host_devices: int = 0):
    """The environment of a subprocess a port test starts: the
    repository's ``src`` on the path, jax on the CPU, one OpenMP (so one
    torch) thread and one XLA CPU thread, so that it does not contend
    with the other test workers for cores; ``host_devices`` forces that
    many XLA host devices in it (and in it only)."""
    flags = "--xla_cpu_multi_thread_eigen=false " \
        "intra_op_parallelism_threads=1"
    if host_devices:
        flags = f"--xla_force_host_platform_device_count={host_devices} " \
            + flags
    return {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
            "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
            "MKL_NUM_THREADS": "1", "XLA_FLAGS": flags}


@pytest.fixture(autouse=True, scope="session")
def _one_torch_thread():
    """Small CPU shapes gain nothing from torch's thread pool or numpy's
    BLAS pool, and their spinning threads contend with the other test
    workers' (beside six busy workers on eight cores, a 200 x 200 matrix
    product on eight BLAS threads took ~30 ms): every port test module
    imports this fixture, so that it runs on one torch thread and one
    BLAS thread. Session-scoped, it is set before the session
    fixtures (the models and JAX references the modules share) are
    built, and it stays for the rest of the worker's session."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:            # numpy keeps its pool
        limits = None
    else:
        limits = threadpool_limits(1, user_api="blas")
    yield
    if limits is not None:
        limits.restore_original_limits()
    torch.set_num_threads(n)

# the golden harness's CAMD settings (tests/data/make_golden_fifo.py)
GOLDEN_CAMD = dict(samples_per_round=2, max_rounds=2, min_samples=2,
                   max_clusters=8)
PRELOAD = ["torch", "torch.distributed", "numpy", "jax", "jax.numpy",
           "repro_torch.serving.engine", "repro_torch.launch.mesh",
           "repro_torch.convert", "torch_ranks"]


def _entry(fn, rank, n, store_path, args, queue):
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        pass
    else:
        threadpool_limits(1, user_api="blas")
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n)
    try:
        queue.put((rank, True, fn(*args)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def spawn(fn, n, tmp_path, *args):
    """``fn(*args)`` on ranks 0..n-1 of one gloo group; [result by rank]."""
    ctx = mp.get_context("forkserver")
    # the server imports these once; every rank forks from it
    ctx.set_forkserver_preload(PRELOAD)
    queue = ctx.Queue()
    os.makedirs(str(tmp_path), exist_ok=True)
    store = os.path.join(str(tmp_path), f"store-{fn.__name__}-{n}")
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, n, store, args, queue))
             for r in range(n)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        while len(got) < n:
            try:
                r, ok, out = queue.get(timeout=1.0)
                got[r] = (ok, out)
                continue
            except queue_mod.Empty:
                pass
            # a rank that died without a result (or a hang) fails at once
            dead = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode is not None]
            if dead or time.monotonic() > deadline:
                raise AssertionError(
                    f"ranks {dead or 'all'} gave no result (exit codes "
                    f"{[p.exitcode for p in procs]}, {len(got)} of {n} "
                    "results)")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [f"rank {r}:\n{out}" for r, (ok, out) in sorted(got.items())
           if not ok]
    if bad:
        raise AssertionError("\n".join(bad))
    return [got[r][1] for r in range(n)]


class RankNoise:
    """The reference engine's Gumbel draws (``split(key)`` at admission,
    ``fold_in(decode_key, t)`` a fused step, or with ``legacy`` a
    ``split(key)`` a step of the per-token loop, as
    ``test_torch_engine_camd.ReferenceNoise``), as the port's noise
    source; every rank draws every row and keeps its own."""

    def __init__(self, seed: int, legacy: bool = False):
        import jax
        self.jax = jax
        self.key = jax.random.PRNGKey(seed)
        self.decode_key = jax.random.fold_in(jax.random.PRNGKey(seed),
                                             0x6d6163)
        self.legacy = legacy

    def _gumbel(self, key, shape):
        import jax.numpy as jnp
        return torch.from_numpy(np.array(self.jax.random.gumbel(
            key, shape, jnp.float32)))

    def first(self, n, vocab):
        self.key, *keys = self.jax.random.split(self.key, n + 1)
        return torch.cat([self._gumbel(k, (1, vocab)) for k in keys])

    def step(self, t, batch, vocab):
        if self.legacy:
            self.key, k = self.jax.random.split(self.key)
        else:
            k = self.jax.random.fold_in(self.decode_key, t)
        return self._gumbel(k, (batch, vocab))


@dataclasses.dataclass
class FakeWorld:
    """A rank world's shape, coordinates and device, with no group: what
    the engine's and the model builder's checks and cuts read before any
    collective."""
    dp: int
    model: int
    rank: int = 0
    backend: str = "gloo"
    device: torch.device = torch.device("cpu")
    axis_names = ("data", "model")

    @property
    def size(self):
        return self.dp * self.model

    @property
    def shape(self):
        return {"data": self.dp, "model": self.model}

    @property
    def coords(self):
        return divmod(self.rank, self.model)


# a config's sub-configs, by field, as plain dicts in a spawned rank
_SUB_CONFIGS = {"vision": "VisionConfig", "moe": "MoEConfig",
                "ssm": "SSMConfig", "rglru": "RGLRUConfig"}


def config_fields(cfg):
    """A (JAX or port) config's fields as plain values, its vision tower,
    MoE, SSD and RG-LRU settings as dicts: what ``port_config`` takes in a
    spawned rank."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    for name in _SUB_CONFIGS:
        if fields.get(name) is not None:
            fields[name] = dataclasses.asdict(fields[name])
    return fields


def port_config(fields):
    from repro_torch import config as tconfig
    fields = dict(fields)
    for name, cls in _SUB_CONFIGS.items():
        if isinstance(fields.get(name), dict):
            fields[name] = getattr(tconfig, cls)(**fields[name])
    return tconfig.ModelConfig(**fields)


def rank_model(cfg, np_params, world):
    """The rank's model: built for the world, loaded with its blocks of
    the reference's weights (``convert.rank_params``)."""
    from repro_torch.convert import rank_params
    from repro_torch.models.model import build_model
    model = build_model(cfg, torch.float32, device="cpu", world=world)
    model.load_state_dict(rank_params(np_params, cfg, world))
    return model


def digest(results):
    """Each result's tokens, counts and floats, candidates in token
    order, as plain lists."""
    out = []
    for r in sorted(results, key=lambda r: r.uid):
        cands = sorted(([int(t) for t in c["tokens"]], float(c["sum_lp"]),
                        float(c["score"])) for c in r.candidates)
        out.append({"uid": int(r.uid),
                    "tokens": [int(t) for t in r.tokens],
                    "tokens_spent": int(r.tokens_spent),
                    "rounds": int(r.rounds),
                    "n_candidates": int(r.n_candidates),
                    "candidates": [c[0] for c in cands],
                    "sum_lp": [c[1] for c in cands],
                    "score": [c[2] for c in cands],
                    "p_star": float(r.p_star),
                    "best_score": float(r.best_score)})
    return out


def serve_cases(dp, model_ranks, cfg_fields, np_params, cases):
    """Serve each case ``(name, engine kwargs, requests, prompt length)``
    on this rank of a (dp, model) mesh, the golden harness's requests
    (``tests/data/make_golden_fifo.py``'s ``submit``); returns {name:
    record}: the admissions, streams, pool, arena and scheduler stats and
    the rank's placement."""
    from repro_torch import config as tconfig
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.serving.engine import Request, ServeEngine
    cfg = port_config(cfg_fields)
    mesh = make_rank_mesh(dp, model_ranks, device="cpu")
    model = rank_model(cfg, np_params, mesh.world)
    out = {}
    for name, kw, n_req, plen in cases:
        kw = dict(kw)
        paged_kv = tconfig.PagedKVConfig(page_size=8,
                                          **kw.pop("paged_kv", {}))
        camd = tconfig.CAMDConfig(**{**GOLDEN_CAMD, **kw.pop("camd", {})})
        eng = ServeEngine(
            model, slots=4, cache_len=32,
            sampling=tconfig.SamplingConfig(max_new_tokens=6,
                                            temperature=0.8),
            camd=camd,
            n_candidates=3, max_new_tokens=6, eos_id=1, seed=0,
            paged_kv=paged_kv, mesh=mesh,
            noise=RankNoise(0, legacy=kw.get("macro_steps") == 0), **kw)
        admitted = []
        admit = eng._admit

        def spy(req, slot_ids, limit=None, admit=admit):
            admitted.append([int(req.uid), [int(s) for s in slot_ids]])
            return admit(req, slot_ids, limit=limit)

        eng._admit = spy
        rng = np.random.default_rng(0)
        for i in range(n_req):
            eng.submit(Request(uid=i, prompt=rng.integers(
                2, cfg.vocab_size, plen).astype(np.int32)))
        with torch.inference_mode():
            res = eng.run()
        rec = {"admitted": admitted, "streams": digest(res),
               "sched": eng.sched_stats(), "B_local": eng.B_local,
               "experts": None if model.layers[0].moe is None else
               list(model.layers[0].moe.w_gate.shape),
               "eager_body": eng._eager_body,
               "host_syncs": eng.host_syncs,
               "total_steps": eng.total_steps}
        if eng.arena is not None:
            eng.arena.check()
            rec["arena"] = eng.arena_stats()
        if eng.paged:
            eng.pool.check()
            rec.update(pool=eng.pool.stats(), mirror_peak=eng.mirror_peak,
                       pool_pages=int(eng.state.cache["k_pages"].shape[1]),
                       own_pages=eng._own_pages,
                       kv_heads=int(eng.state.cache["k_pages"].shape[3]),
                       reserved=int(eng._reserved))
        out[name] = rec
    return out


def tp_units(qwen_fields, qwen_params, toks, dec_toks, bias_fields):
    """Two model ranks (a (1, 2) mesh): the vocab-parallel embedding and
    unembedding and a row-parallel ``Dense`` on seeded inputs (returned
    whole, for the parent's expected values), the reduced qwen3's
    prefill and decode logits on the reference's weights (both impls),
    and a seeded build's parameters and logits for the reduced qwen3 and
    the reduced qwen2.5-32b (qkv biases)."""
    from repro_torch.distributed.context import constrain_logits
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models.layers import Dense, embed
    from repro_torch.models.model import build_model
    world = make_rank_mesh(1, 2, device="cpu").world
    m = world.coords[1]
    g = torch.Generator().manual_seed(0)
    table = torch.randn(64, 16, generator=g)
    tokens = torch.randint(0, 64, (3, 7), generator=g)
    h = torch.randn(3, 16, generator=g)
    kernel = torch.randn(24, 8, generator=g)
    x = torch.randn(5, 24, generator=g)
    dense = Dense(12, 8)
    dense.kernel.data = kernel[m * 12:(m + 1) * 12].clone()
    dense.reduce_world = world
    rows = table[m * 32:(m + 1) * 32]
    out = {"inputs": dict(table=table.numpy(), tokens=tokens.numpy(),
                          h=h.numpy(), kernel=kernel.numpy(), x=x.numpy()),
           "embed": embed(rows, tokens, m * 32, world).numpy(),
           "unembed": constrain_logits(h @ rows.T, world).numpy(),
           "dense": dense(x[:, m * 12:(m + 1) * 12]).numpy()}
    cfg = port_config(qwen_fields)
    model = rank_model(cfg, qwen_params, world)
    B, L = toks.shape
    with torch.inference_mode():
        for impl in ("torch", "cuda"):
            lg, _, cache = model.prefill(
                torch.as_tensor(toks, dtype=torch.long),
                model.make_cache(B, 48), impl=impl)
            steps = [lg.numpy()]
            for tok in dec_toks:
                lg, _, cache = model.decode_step(
                    torch.as_tensor(tok, dtype=torch.long), cache, impl=impl)
                steps.append(lg.numpy())
            out[f"logits_{impl}"] = steps
        out["kv_heads"] = int(cache["k"].shape[3])
        seeded = {}
        for name, fields in (("qwen3", qwen_fields),
                             ("qwen2.5", bias_fields)):
            built = build_model(port_config(fields), torch.float32,
                                device="cpu", seed=0, world=world)
            lg, _, _ = built.prefill(torch.as_tensor(toks, dtype=torch.long),
                                     built.make_cache(B, 48))
            seeded[name] = ({k: v.numpy() for k, v in
                             built.state_dict().items()}, lg.numpy())
        out["seeded"] = seeded
    return out


def cli_runs(argvs):
    """``serve.main`` on this rank for each argv (the group is up, so
    ``--mesh`` serves as ranks); returns [(stdout, streams digest, the
    engine's eager-body flag, its kernel launches)]."""
    import contextlib
    import io

    from repro_torch.launch import serve
    out = []
    for argv in argvs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = serve.main(argv)
        out.append((buf.getvalue(), digest(res["results"]),
                    res["engine"]._eager_body, res["launches"]))
    return out


def vlm_requests(cfg, req_cls, n_req=3, n_img=2):
    """``n_req`` image requests over ``n_img`` seeded images (a repeated
    image hits the feature memo), prompts of 5-9 tokens."""
    v = cfg.vision
    rng = np.random.default_rng(7)
    imgs = rng.standard_normal((n_img, v.image_h, v.image_w,
                                v.channels)).astype(np.float32)
    return [req_cls(uid=i, prompt=rng.integers(
        2, cfg.vocab_size, 6).astype(np.int32),
        image=imgs[i % n_img]) for i in range(n_req)]


def vlm_digest(results):
    """``digest`` with each request's candidates' cross-modal S_align,
    candidates in token order."""
    out = digest(results)
    for rec, r in zip(out, sorted(results, key=lambda r: r.uid)):
        cands = sorted(([int(t) for t in c["tokens"]],
                        c.get("s_align_xmodal")) for c in r.candidates)
        rec["s_align_xmodal"] = [None if c[1] is None else float(c[1])
                                 for c in cands]
    return out


# the vlm engine cases' settings (both packages)
VLM_ENGINE = dict(slots=4, cache_len=32, mode="camd", n_candidates=3,
                  max_new_tokens=6, eos_id=1, seed=0, macro_steps=8,
                  xmodal_rescore=True)
VLM_CAMD = dict(GOLDEN_CAMD, samples_per_round=3)   # rounds span shards


def vlm_ranks(dp, model_ranks, cfg_fields, np_params, images):
    """This rank of a (dp, model) mesh on the reduced llava with the
    reference's weights: the tower's encode of ``images`` and the rank's
    ``vision.*`` blocks, then CAMD on ``paged_cuda`` (the kernels' plain
    versions on the CPU) with cross-modal rescoring over
    ``vlm_requests``; returns the encode, the blocks, the admissions,
    streams and the engine's image and rescoring counters."""
    from repro_torch import config as tconfig
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.serving.engine import Request, ServeEngine
    cfg = port_config(cfg_fields)
    mesh = make_rank_mesh(dp, model_ranks, device="cpu")
    model = rank_model(cfg, np_params, mesh.world)
    with torch.inference_mode():
        enc = model.encode_image(torch.from_numpy(images)).numpy()
    eng = ServeEngine(
        model, impl="paged_cuda", mesh=mesh, noise=RankNoise(0),
        sampling=tconfig.SamplingConfig(max_new_tokens=6, temperature=0.8),
        camd=tconfig.CAMDConfig(**VLM_CAMD),
        paged_kv=tconfig.PagedKVConfig(page_size=8), **VLM_ENGINE)
    admitted = []
    admit = eng._admit

    def spy(req, slot_ids, limit=None):
        admitted.append([int(req.uid), [int(s) for s in slot_ids]])
        return admit(req, slot_ids, limit=limit)

    eng._admit = spy
    for req in vlm_requests(cfg, Request):
        eng.submit(req)
    with torch.inference_mode():
        res = eng.run()
    eng.pool.check()
    return {"encode": enc,
            "vision": {k: v.numpy() for k, v in model.state_dict().items()
                       if k.startswith("vision.")},
            "admitted": admitted, "streams": vlm_digest(res),
            "image_encodes": eng.image_encodes,
            "image_feat_hits": eng.image_feat_hits,
            "rescored": eng.xmodal_rescored, "parted": eng.xmodal_parted,
            "evid_rows": int(eng._evid.shape[0]),
            "total_steps": eng.total_steps, "host_syncs": eng.host_syncs,
            "pool": eng.pool.stats(), "reserved": int(eng._reserved)}


def moe_units(dp, model_ranks, cfg_fields, np_params, cases):
    """This rank of a (dp, model) mesh on the reduced granite with the
    reference's weights: its layer 0 MoE (cut by the rank build) on each
    case ``(name, x, split, MoE overrides)``: the whole x, or with
    ``split`` the rank's data block of its rows, through ``moe_apply``
    on both impls; returns {name: (output rows, aux)}, the expert block
    the rank holds and, under "shared", a seeded variant with a shared
    expert on the "decode drops" rows in both layouts (its shared MLP's
    gate shape, the whole rows' output, the rank's rows' output)."""
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.distributed.context import release_world
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import moe_apply, moe_aux
    cfg = port_config(cfg_fields)
    world = make_rank_mesh(dp, model_ranks, device="cpu").world
    moe = rank_model(cfg, np_params, world).layers[0].moe
    d = world.coords[0]
    out = {"experts": list(moe.w_gate.shape),
           "w_down": list(moe.w_down.shape)}
    with torch.inference_mode():
        for name, x, split, over in cases:
            c = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **over))
            xt = torch.from_numpy(x)
            if split:
                n = x.shape[0] // dp
                xt = xt[d * n:(d + 1) * n]
            got = {}
            for impl in ("torch", "cuda"):
                y, routing = moe_apply(moe, c, xt, impl=impl,
                                       split_rows=split)
                got[impl] = (y.numpy(), {k: float(v) for k, v in
                                         moe_aux(*routing).items()})
            assert np.array_equal(got["torch"][0], got["cuda"][0])
            out[name] = got["cuda"]
        # a shared expert (kimi-k2's kind), cut as the dense gated MLP:
        # the seeded model's layer 0 on the decode drop case's rows
        name, x, _, over = next(c for c in cases if c[0] == "decode drops")
        c = cfg.with_overrides(moe=dataclasses.replace(
            cfg.moe, num_shared_experts=1, **over))
        shared = build_model(c, torch.float32, device="cpu", seed=0,
                             world=world).layers[0].moe
        n = x.shape[0] // dp
        out["shared"] = (
            list(shared.shared.w_gate.kernel.shape),
            moe_apply(shared, c, torch.from_numpy(x), impl="cuda")[0].numpy(),
            moe_apply(shared, c, torch.from_numpy(x[d * n:(d + 1) * n]),
                      impl="cuda", split_rows=True)[0].numpy())
    release_world(world)
    return out


def shard_map_ranks(cfg_fields, moe_params, x, meshes):
    """``moe_apply_shard_map`` on this rank of each ``(dp, model,
    model_axis)`` mesh: the rank holds the router and shared MLP whole,
    its data block of the experts (with ``model_axis`` its model block of
    their ``f``) and its data block of x's rows. Returns {mesh: (output
    rows, aux)} on both impls, which must agree."""
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.distributed.context import release_world
    from repro_torch.models.moe import MoE
    from repro_torch.models.moe_shard_map import moe_apply_shard_map
    cfg = port_config(cfg_fields)
    E = cfg.moe.num_experts
    out = {}
    for dp, mp, model_axis in meshes:
        world = make_rank_mesh(dp, mp, device="cpu").world
        d, m = world.coords
        p = MoE(cfg, device="cpu")
        e_blk = slice(d * E // dp, (d + 1) * E // dp)
        f = cfg.moe.expert_d_ff
        f_blk = slice(m * f // mp, (m + 1) * f // mp) if model_axis \
            else slice(0, f)
        p.router.kernel.data = torch.from_numpy(moe_params["router"]["kernel"])
        for name in ("w_gate", "w_up"):
            getattr(p, name).data = torch.from_numpy(
                moe_params[name][e_blk][:, :, f_blk].copy())
        p.w_down.data = torch.from_numpy(
            moe_params["w_down"][e_blk][:, f_blk].copy())
        for name in ("w_gate", "w_up", "w_down") if p.shared else ():
            getattr(p.shared, name).kernel.data = torch.from_numpy(
                moe_params["shared"][name]["kernel"])
        n = x.shape[0] // dp
        x_loc = torch.from_numpy(x[d * n:(d + 1) * n])
        got = {}
        with torch.inference_mode():
            for impl in ("torch", "cuda"):
                y, aux = moe_apply_shard_map(p, cfg, x_loc, world,
                                             model_axis=model_axis,
                                             impl=impl)
                got[impl] = (y.numpy(), {k: float(v) for k, v in
                                         aux.items()})
        assert np.array_equal(got["torch"][0], got["cuda"][0])
        out[(dp, mp)] = got["cuda"]
        release_world(world)
    return out


def moe_ranks(units, shard_maps, serves):
    """One spawn's MoE work on this rank, its worlds one after another:
    ``moe_units`` on each mesh of ``units`` ((cfg fields, params, meshes,
    cases)), ``shard_map_ranks`` on ``shard_maps`` ((cfg fields, MoE
    params, x, meshes), or None) and ``serve_cases`` on each (mesh,
    cases) of ``serves`` ((cfg fields, params, [(mesh, cases)]))."""
    from repro_torch.distributed.context import get_world, release_world
    fields, params, meshes, cases = units
    out = {"units": {mesh: moe_units(*mesh, fields, params, cases)
                     for mesh in meshes}}
    if shard_maps is not None:
        out["shard_map"] = shard_map_ranks(*shard_maps)
    fields, params, runs = serves
    out["serve"] = {}
    for mesh, cases in runs:
        out["serve"][mesh] = serve_cases(*mesh, fields, params, cases)
        release_world(get_world())
    return out


def recurrent_units(cfg_fields, np_params, x, x1, cache_len):
    """Every layer of a reduced recurrent or hybrid model on this rank of
    a (1, 2) mesh, on the reference's weights: each block's prefill of x
    (B, L, d) and one decode step of x1 (B, 1, d) from its state (an SSD
    or RG-LRU block's, or a local layer's ring of ``cache_len`` slots,
    on both impls), a layer's MLP on x; returns {layer: outputs} (the
    rank's blocks of the state leaves as it holds them)."""
    from repro_torch.distributed.context import release_world
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import rglru as rglru_lib
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models.layers import mlp
    from repro_torch.models.transformer import window_for
    cfg = port_config(cfg_fields)
    world = make_rank_mesh(1, 2, device="cpu").world
    model = rank_model(cfg, np_params, world)
    u, u1 = torch.from_numpy(x), torch.from_numpy(x1)
    B, L, _ = u.shape
    out = {}

    def numpy(tree):
        return {k: v.clone().numpy() for k, v in tree.items()}
    with torch.inference_mode():
        for i, blk in enumerate(model.layers):
            rec = {}
            if blk.kind == "ssm":
                y, st = ssm_lib.ssm_prefill(blk.ssm, cfg, u)
                rec["prefill"] = (y.numpy(), numpy(st))
                y1 = ssm_lib.ssm_decode(blk.ssm, cfg, u1, st)
                rec["decode"] = (y1.numpy(), numpy(st))
            elif blk.kind == "rglru":
                y, st = rglru_lib.rglru_prefill(blk.rglru, cfg, u)
                rec["prefill"] = (y.numpy(), numpy(st))
                y1 = rglru_lib.rglru_decode(blk.rglru, cfg, u1, st)
                rec["decode"] = (y1.numpy(), numpy(st))
            else:
                win = window_for(cfg, blk.kind)
                positions = torch.arange(L).expand(B, L)
                for impl in ("torch", "cuda"):
                    y, (k, v) = attn_lib.attn_prefill(
                        blk.attn, cfg, u, positions, window=win, impl=impl)
                    kc = torch.zeros((B, cache_len) + tuple(k.shape[2:]))
                    vc = torch.zeros_like(kc)
                    attn_lib.prefill_into_cache(kc, vc, k, v)
                    pos = torch.full((B,), L, dtype=torch.int32)
                    y1 = attn_lib.attn_decode(blk.attn, cfg, u1, kc, vc,
                                              pos, window=win, impl=impl)
                    rec[impl] = (y.numpy(), y1.numpy(),
                                 dict(k=kc.numpy(), v=vc.numpy()))
                rec["q_heads"] = blk.attn.wq.kernel.shape[1] // \
                    cfg.resolved_head_dim
            if blk.mlp is not None:
                rec["mlp"] = mlp(blk.mlp, u).numpy()
            out[i] = rec
    out["kv_heads"] = model.kv_heads
    release_world(world)
    return out


def recurrent_ranks(units, serves):
    """One spawn's recurrent work on this rank, its worlds one after
    another: ``recurrent_units`` for each (cfg fields, params, x, x1,
    cache_len) of ``units`` on a (1, 2) mesh (none on four ranks), then
    ``serve_cases`` on each (cfg fields, params, mesh, cases) of
    ``serves``."""
    from repro_torch.distributed.context import get_world, release_world
    out = {"units": [recurrent_units(*u) for u in units], "serve": {}}
    for fields, params, mesh, cases in serves:
        out["serve"][fields["name"], mesh] = serve_cases(
            *mesh, fields, params, cases)
        release_world(get_world())
    return out
