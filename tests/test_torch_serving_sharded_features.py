"""Mesh-parallel serving of the port: policies, prefix cache,
disaggregation, the front-end and the shard-local checks.

With ``test_torch_serving_sharded.py``'s harness (the golden tiny model,
the reference's weights and Gumbel draws, dp logical shards on the CPU):
the port at dp 2 and 4 equals the JAX single-device engine under the
fifo and coverage policies (every shard admitting) and with the prefix
cache (hits whose pages live on one shard, hitting candidates on
others); at dp 2 with ``prefill_shards=1`` and chunked prefill it equals
the single-device chunked engine with every prompt and chunk page on
shard 0; the async front-end over a dp-2 engine equals the JAX front-end
over the single-device engine. On the port alone: every tail, frontier
and legacy page a slot writes lies in its own shard and the frontier
counters balance per shard, idle rows point at their own shard's
quarantine page, a prompt hold its shard cannot fund admits nothing,
speculation's invalid writes reach only the sink page, the pool rounds up
to a multiple of dp (int8 scales follow), the specs the engine keeps
equal the reference's rule table on the reference engine's state, and a
mesh over several devices or with a model axis raises
``NotImplementedError``; the serve CLI's ``--mesh`` takes exactly two
positive ints, and not beside ``--serve-dp``.
"""
import numpy as np
import pytest
import torch

from repro.config import PagedKVConfig as JPaged
from repro.distributed import sharding as jshd
from repro.serving import AsyncServeFrontend as JFrontend
from repro.serving import Request as JRequest
from repro.serving import traffic as jtraffic
from repro_torch import config as tconfig
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import ServeMesh, make_serve_mesh
from repro_torch.serving import AsyncServeFrontend, traffic
from repro_torch.serving.engine import Request
from test_torch_engine_camd import _one_torch_thread  # noqa: F401
from test_torch_frontend import _drive
from test_torch_serving_sharded import (_conserved, _golden_requests,
                                        _port_run, _reference, _streams,
                                        make_engine, model3,  # noqa: F401
                                        port_engine)


@pytest.mark.parametrize("policy", ["fifo", "coverage"])
def test_sharded_streams_equal_reference_per_policy(model3, policy):
    """Shard-local affordability does not bind on an adequate pool, so the
    policies decide as on one device; under fifo every shard serves."""
    kw = dict(mode="camd", impl="paged", macro_steps=8, sched_policy=policy)
    ref = _reference(model3, n=4, **kw)
    for dp in (2, 4):
        eng = port_engine(model3[3], dp=dp, **kw)
        assert _port_run(eng, _golden_requests(model3[0], 4)) == ref
        ss = eng.sched_stats()
        assert len(ss["admitted_per_shard"]) == dp, ss
        assert sum(ss["admitted_per_shard"].values()) == \
            ss["admitted_candidates"]
        _conserved(eng)


def _shared_prefix_prompts(cfg):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, cfg.vocab_size, 19).astype(np.int32)
               for _ in range(4)]
    for p in prompts[1:]:
        p[:17] = prompts[0][:17]        # 2 shared full pages at ps 8
    return prompts


def test_sharded_prefix_cache_equals_reference(model3):
    """Prefix hits across requests whose cached pages live on one shard
    and whose hitting candidates sit on others."""
    cfg, jmodel, jparams, model = model3
    prompts = _shared_prefix_prompts(cfg)
    jeng = make_engine(jmodel, jparams, mode="camd", impl="paged",
                       macro_steps=8, cache_len=64, prefix_cache=True)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(uid=i, prompt=p))
    ref = _streams(jeng.run())
    for dp in (2, 4):
        eng = port_engine(model, mode="camd", impl="paged", macro_steps=8,
                          dp=dp, cache_len=64, prefix_cache=True)
        got = _port_run(eng, [Request(uid=i, prompt=p)
                              for i, p in enumerate(prompts)])
        assert got == ref
        pc = eng.kv_stats()["prefix_cache"]
        assert pc["hits"] == jeng.kv_stats()["prefix_cache"]["hits"] > 0
        _conserved(eng)


def test_disaggregated_chunked_prefill_equals_reference(model3):
    """``prefill_shards=1`` with chunks of 8 on prompts of 19-27 tokens:
    streams equal the single-device chunked engine's, every prompt and
    chunk page lies on shard 0, every tail and frontier page on its
    slot's own shard."""
    cfg, jmodel, jparams, model = model3
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in (19, 27, 21, 24)]
    kw = dict(mode="camd", impl="paged", macro_steps=8, cache_len=64,
              prefill_chunk=8)
    jeng = make_engine(jmodel, jparams, **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(uid=i, prompt=p))
    ref = _streams(jeng.run())
    eng = port_engine(model, dp=2, prefill_shards=1, **kw)
    seeded, staged = _spy_pages(eng)
    got = _port_run(eng, [Request(uid=i, prompt=p)
                          for i, p in enumerate(prompts)])
    assert got == ref
    assert eng.sched_stats()["chunk_calls"] == \
        jeng.sched_stats()["chunk_calls"] > 0
    prompt_pages = [p for info in seeded for p in info]
    assert prompt_pages and {eng.pool.shard_of(p) for p in prompt_pages} \
        == {0}
    assert {eng._slot_shard(s) for s, _ in staged} == {0, 1}
    for s, pages in staged:
        assert {eng.pool.shard_of(p) for p in pages} <= {eng._slot_shard(s)}
    _conserved(eng)


def _spy_pages(eng):
    """Record the prompt pages each request seeds and the pages each
    slot takes as its own (CoW tail, staged frontier, legacy-loop
    page)."""
    seeded, owned = [], []
    seed, stage, alloc = (eng._seed_paged_slots, eng._stage_frontier,
                          eng._alloc_step_pages)

    def seed_spy(info, slot_ids, lim):
        seed(info, slot_ids, lim)
        seeded.append(list(info["prompt_pages"]))
        for s in slot_ids:
            owned.append((s, eng._slot_pages[s][len(info["prompt_pages"]):]))

    def stage_spy():
        staged = stage()
        owned.extend((s, pages) for s, (_, pages) in staged.items())
        return staged

    def alloc_spy():
        before = [len(p) for p in eng._slot_pages]
        alloc()
        owned.extend((s, eng._slot_pages[s][n:])
                     for s, n in enumerate(before))

    eng._seed_paged_slots, eng._stage_frontier = seed_spy, stage_spy
    eng._alloc_step_pages = alloc_spy
    return seeded, owned


# ---------------------------------------------------------------------------
# shard-local conservation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [0, 8])
def test_shard_local_pages_and_frontiers(model3, k):
    """Every page a slot writes comes from its own shard's range, the
    frontier counters balance per shard, and the drained pool is
    conserved, with the per-token loop (K 0) and macro-steps (K 8)."""
    cfg, _, _, model = model3
    eng = port_engine(model, mode="best_of_n", impl="paged", macro_steps=k,
                      dp=2)
    _, owned = _spy_pages(eng)
    _port_run(eng, _golden_requests(cfg, 3))
    assert sum(len(p) for _, p in owned) > 0
    for s, pages in owned:
        for p in pages:
            assert eng.pool.shard_of(p) == eng._slot_shard(s), (s, p)
    st = eng.pool.stats()
    for key in ("frontier_staged", "frontier_returned"):
        assert st[key] == sum(sh[key] for sh in st["shards"])
    assert (st["frontier_staged"] > 0) == (k > 0)
    _conserved(eng)


def test_quarantine_is_shard_local(model3):
    """Idle rows point at their own shard's quarantine page at init and
    after candidates retire; the staged frontier's spare entries too."""
    cfg, _, _, model = model3
    eng = port_engine(model, mode="greedy", impl="paged", macro_steps=8,
                      dp=2)
    q = [eng.pool.quarantine_page(eng._slot_shard(s)) for s in range(eng.B)]
    assert q == [0, 0, eng.pool.pages_per_shard, eng.pool.pages_per_shard]
    bt = eng.state.cache["block_table"]
    assert all((bt[s] == q[s]).all() for s in range(eng.B))
    _port_run(eng, _golden_requests(cfg, 2))
    fr = eng._frontier
    for s in range(eng.B):
        assert (bt[s] == q[s]).all()
        assert eng.pool.shard_of(int(fr[s, -1])) == eng._slot_shard(s)
    _conserved(eng)


def test_affordable_refuses_unfundable_prompt_hold(model3):
    """A request whose prompt pages are pinned to an exhausted shard is
    not admitted on the other shard's capacity."""
    _, _, _, model = model3
    eng = port_engine(model, mode="camd", impl="paged", macro_steps=8,
                      dp=2)
    info = {"prompt_len": 19, "page_shard": 0,      # 2 full pages at ps 8
            "prompt_pages": [], "prefix_len": 0}
    drained = eng.pool.alloc(eng.pool.free_pages_in(0), 0)
    assert eng._paged_affordable(info, 2, 4) == 0
    eng.pool.free(drained)
    assert eng._paged_affordable(info, 2, 4) == 2
    eng.pool.check()


def test_speculation_drops_only_into_the_sink(model3):
    """A speculating dp-2 engine: greedy streams equal the unsharded
    speculating engine's, and every invalid verify write lands on the
    sink page past the last shard, never on a shard's quarantine page."""
    cfg, _, _, model = model3
    outs = []
    for dp in (0, 2):
        eng = port_engine(model, mode="greedy", impl="paged", macro_steps=4,
                          dp=dp, spec_k=4, cache_len=64)
        outs.append(_port_run(eng, _golden_requests(cfg, 3)))
        _conserved(eng)
    assert outs[0] == outs[1]
    pool = eng.state.cache["k_pages"]
    assert pool.shape[1] == eng.pool.num_pages + 1
    assert pool[:, eng.pool.num_pages].abs().sum() > 0        # the sink
    for s in range(eng.dp):
        assert pool[:, eng.pool.quarantine_page(s)].abs().sum() == 0


def test_pool_rounds_to_shards_and_keeps_specs(model3):
    """The pool is rounded up to a multiple of dp with a quarantine page a
    shard, the int8 scale pools follow its size, and the specs the engine
    keeps equal the reference's rule table on the reference engine's
    state (cache leaves and every per-slot field) at the same mesh."""
    cfg, jmodel, jparams, model = model3
    eng = port_engine(model, mode="camd", impl="paged", macro_steps=8,
                      dp=4, paged_kv=tconfig.PagedKVConfig(
                          page_size=8, num_pages=13, kv_dtype="int8"))
    assert eng.pool.num_pages == 16 and eng.pool.pages_per_shard == 4
    c = eng.state.cache
    assert c["k_pages"].shape[1] == c["k_scale"].shape[1] == 16
    assert eng.kv_stats()["bytes_per_page"] == eng.pool.bytes_per_page > 0
    sp = eng.state_specs
    assert sp["cache"]["k_pages"] == (None, "data", None, None, None)
    assert sp["cache"]["k_scale"] == (None, "data", None, None)
    assert sp["cache"]["block_table"] == ("data", None)
    assert sp["last_token"] == ("data",) and sp["bias"] == ("data", None)
    assert all(all(a is None for a in s) for s in eng.param_specs.values())

    class FakeMesh:
        shape = {"data": 4, "model": 1}
        axis_names = ("data", "model")

    jeng = make_engine(jmodel, jparams, mode="camd", impl="paged",
                       macro_steps=8, paged_kv=JPaged(
                           page_size=8, num_pages=16, kv_dtype="int8"))
    ref = jshd.engine_state_specs(cfg, jeng.state, FakeMesh)

    def pad(spec, leaf):
        return tuple(spec) + (None,) * (leaf.ndim - len(spec))

    for f in ref._fields:
        if f != "cache":
            assert sp[f] == pad(getattr(ref, f), getattr(jeng.state, f)), f
    rc, jc = ref.cache, jeng.state.cache
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        assert sp["cache"][name] == pad(rc["super"][0][name],
                                        jc["super"][0][name]), name
    for name in ("pos", "block_table"):
        assert sp["cache"][name] == pad(rc[name], jc[name]), name


def test_meshes_the_port_cannot_place_raise(model3):
    """A one-process mesh over several devices or with a model axis above
    1 raises NotImplementedError naming the rank entry point (a rank mesh
    over torch.distributed) and the roadmap; so does nothing else."""
    model = model3[3]
    cpu = torch.device("cpu")
    two = ServeMesh({"data": 2, "model": 1}, ("data", "model"),
                    (cpu, torch.device("cuda", 0)))
    for mesh in (two, make_serve_mesh(2, model=2, device="cpu")):
        with pytest.raises(NotImplementedError,
                           match="make_rank_mesh under torch.distributed.*"
                           "ROADMAP.md"):
            port_engine(model, mode="camd", impl="paged", macro_steps=8,
                        mesh=mesh)
    with pytest.raises(ValueError, match="divide"):
        port_engine(model, mode="camd", impl="paged", macro_steps=8, dp=3)
    with pytest.raises(ValueError, match="paged"):
        port_engine(model, mode="camd", impl="xla", macro_steps=8, dp=2,
                    prefill_shards=1)
    with pytest.raises(ValueError):
        port_engine(model, mode="camd", impl="paged", macro_steps=8, dp=2,
                    prefill_shards=3)


@pytest.mark.parametrize("argv", [
    ["--mesh", "2"], ["--mesh", "2,1,7"], ["--mesh", "0,1"],
    ["--mesh", "2,-1"], ["--mesh", "a,1"], ["--mesh", "2,"],
    ["--mesh", "2,1", "--serve-dp", "2"]])
def test_serve_cli_refuses_a_malformed_mesh(argv, capsys):
    """``--mesh`` is 'dp,model' as two positive ints, and one spelling of
    the shard count: beside ``--serve-dp`` the CLI exits."""
    assert serve_cli.parse_args(["--mesh", "4,2"]).mesh == (4, 2)
    with pytest.raises(SystemExit):
        serve_cli.parse_args(argv)
    assert "--mesh" in capsys.readouterr().err


def test_frontend_over_a_sharded_engine_equals_reference(model3):
    """The async front-end pumping a dp-2 engine, every arrival at 0 and
    request 1 cancelled after its first token: delivered streams, flags,
    results and the engine's counters equal the JAX front-end over the
    single-device engine."""
    cfg, jmodel, jparams, model = model3
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab_size, 6).astype(np.int32)
               for _ in range(5)]
    out = {}
    for name, eng, fe_cls, drive, req_cls in (
            ("jax", make_engine(jmodel, jparams, mode="greedy",
                                impl="paged", macro_steps=4),
             JFrontend, jtraffic.drive_open_loop, JRequest),
            ("port", port_engine(model, mode="greedy", impl="paged",
                                 macro_steps=4, dp=2),
             AsyncServeFrontend, traffic.drive_open_loop, Request)):
        reqs = [req_cls(uid=i, prompt=p) for i, p in enumerate(prompts)]
        traces, delivered = _drive(fe_cls, drive, eng, reqs, (1,))
        out[name] = ([(t.uid, t.n_tokens, t.cancelled) for t in traces],
                     delivered, _streams([eng.result(i) for i in range(5)]),
                     (eng.total_steps, eng.macro_launches, eng.host_syncs))
    assert out["port"] == out["jax"]
    assert out["port"][0][1][2] is True
    _conserved(eng)
