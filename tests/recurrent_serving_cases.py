"""Engine cases of the recurrent and hybrid models, shared by
``test_torch_recurrent_serving_ssm.py`` (mamba2-780m) and
``test_torch_recurrent_serving_hybrid.py`` (recurrentgemma-2b), each of
which defines the session fixture ``arch`` and imports these cases, so
that the two models' engines land on different test workers. A star
import leaves out names with a leading underscore: each file imports
the one-thread fixture ``torch_ranks._one_torch_thread`` by name (without
it torch runs its 8-thread pool, whose spinning threads made these files
20-150x slower beside the other test workers).

The port's ``ServeEngine`` against the JAX package's on the reduced
config in fp32, the reference's weights carried over: greedy streams
token for token (macro-steps of 4, 1 and the per-token loop, K 0), with
the reference's step, launch and host-sync counts and its
``arena_stats()``; CAMD with the reference's Gumbel draws
(``ReferenceNoise``) on 2 slots and 10 requests, where the arena of
2 * 2 + 4 rows bounds prefill-ahead: rounds, candidates and streams
equal, p* within 1e-4 and the arena's counters, ``sizing_stalls``
included, equal. Mesh serving at dp 2 (two logical shards on the CPU,
the arena in two row ranges of 2 * slots_per_shard + 4): greedy streams
and launch counts equal the single-device reference's, CAMD streams the
unsharded port's.
Within the port: cancels at every timing class leave the arena
conserved, and a paged impl is refused. ``StateArena`` runs a
seeded sequence of operations in lockstep with the reference's arena.
The JAX engines are built once a session per model.
"""
import numpy as np
import pytest
import torch

from repro.config import CAMDConfig as JCAMD
from repro.config import SamplingConfig as JSampling
from repro.configs import get_config as jget_config
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JEngine
from repro.serving.state_arena import StateArena as JArena
from repro.serving.state_arena import StateArenaError as JArenaError
from repro_torch import config as tconfig
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.state_arena import StateArena, StateArenaError
from test_torch_engine_camd import ReferenceNoise
from test_torch_recurrent_models import make_pair

CAMD = dict(samples_per_round=2, max_rounds=3, min_samples=2, max_clusters=8)
MAX_NEW = 6


@pytest.fixture(scope="session")
def pair(arch):
    jcfg = jget_config(arch).reduced().with_overrides(dtype="float32")
    return (jcfg,) + make_pair(jcfg)


def _prompts(cfg, n, seed):
    """``n`` prompts of 7 or 11 tokens: the reference engine prefills a
    request alone and compiles a prefill for each prompt length."""
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size, size=(7, 11)[i % 2]).astype(
        np.int32) for i in range(n)]


def _kw(cfg, mode, slots, K):
    return dict(slots=slots, cache_len=64, mode=mode,
                max_new_tokens=MAX_NEW, eos_id=cfg.vocab_size, seed=0,
                macro_steps=K)


def _reference(pair, mode, slots, n, seed):
    jcfg, jmodel, jparams, _ = pair
    eng = JEngine(jmodel, jparams, impl="xla",
                  sampling=JSampling(max_new_tokens=MAX_NEW,
                                     temperature=0.8),
                  camd=JCAMD(**CAMD), **_kw(jcfg, mode, slots, 4))
    for i, p in enumerate(_prompts(jcfg, n, seed)):
        eng.submit(JRequest(uid=i, prompt=p))
    res = sorted(eng.run(), key=lambda r: r.uid)
    return res, eng.arena_stats(), (eng.total_steps, eng.macro_launches,
                                    eng.host_syncs)


@pytest.fixture(scope="session")
def ref_greedy(pair):
    return _reference(pair, "greedy", 4, 5, 0)


@pytest.fixture(scope="session")
def ref_camd(pair):
    return _reference(pair, "camd", 2, 10, 3)


def _engine(pair, mode, slots, K, impl="torch", noise=None, **extra):
    jcfg, _, _, model = pair
    return ServeEngine(model, impl=impl,
                       sampling=tconfig.SamplingConfig(
                           max_new_tokens=MAX_NEW, temperature=0.8),
                       camd=tconfig.CAMDConfig(**CAMD), noise=noise,
                       **_kw(jcfg, mode, slots, K), **extra)


def _port(pair, mode, slots, n, seed, K, impl="torch", noise=None, **extra):
    eng = _engine(pair, mode, slots, K, impl, noise, **extra)
    for i, p in enumerate(_prompts(pair[0], n, seed)):
        eng.submit(Request(uid=i, prompt=p))
    with torch.inference_mode():
        res = sorted(eng.run(), key=lambda r: r.uid)
    eng.arena.check()
    assert eng.arena.in_use == 0
    return res, eng


@pytest.mark.parametrize("K", [4, 1, 0])
def test_greedy_streams_equal_reference(pair, ref_greedy, K):
    """Greedy streams of the port's engine at K 4, 1 and 0 (the per-token
    loop) against the reference engine's at K 4, token for token; at
    K 4 also its step, launch and host-sync counts; its arena's counters
    at every K."""
    exp, exp_arena, exp_counts = ref_greedy
    out, eng = _port(pair, "greedy", 4, 5, 0, K, impl="cuda")
    assert len(out) == len(exp) == 5
    for a, b in zip(exp, out):
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
        assert len(b.tokens) == MAX_NEW        # eos outside the vocab
    assert eng.arena_stats() == exp_arena
    assert eng.arena_stats()["resident_state_bytes"] > 0
    if K == 4:
        assert (eng.total_steps, eng.macro_launches, eng.host_syncs) == \
            exp_counts


def test_camd_equals_reference(pair, ref_camd):
    """CAMD on 2 slots and 10 requests with the reference's noise: rounds,
    candidates, streams and cluster ids equal, p* within 1e-4, and the
    arena's counters equal, prefill-ahead stalled on a full arena the
    same number of times (``sizing_stalls``) and never past its rows."""
    exp, exp_arena, exp_counts = ref_camd
    out, eng = _port(pair, "camd", 2, 10, 3, 4, noise=ReferenceNoise(0))
    assert len(out) == len(exp) == 10
    for a, b in zip(exp, out):
        assert (a.n_candidates, a.rounds, a.tokens_spent,
                a.stopped_early) == (b.n_candidates, b.rounds,
                                     b.tokens_spent, b.stopped_early)
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
        for ca, cb in zip(a.candidates, b.candidates):
            assert ca["tokens"].tolist() == cb["tokens"].tolist()
            assert ca["cluster"] == cb["cluster"]
        np.testing.assert_allclose(a.p_star, b.p_star, rtol=1e-4, atol=1e-4)
    assert sum(r.rounds for r in out) > len(out)      # some went again
    stats = eng.arena_stats()
    assert stats == exp_arena
    assert stats["sizing_stalls"] > 0
    assert stats["max_in_use"] == stats["num_rows"] == 2 * 2 + 4
    assert (eng.total_steps, eng.macro_launches, eng.host_syncs) == \
        exp_counts


def test_dp2_streams_equal_reference(pair, ref_greedy):
    """A dp-2 mesh: greedy on 4 slots (2 a shard) gives the single-device
    reference's streams and step, launch and host-sync counts; CAMD on 4
    slots with the reference's noise gives the unsharded port's streams,
    candidates and rounds. The arena holds 2 * slots_per_shard + 4 rows
    a shard (16 here against one device's 12, so prefill-ahead, which
    the arena bounds, never waits in either) and ends conserved. Where
    the arena does bind, a dp-2 engine's larger arena admits requests at
    other decode steps, whose noise differs: the reference's too."""
    mesh = make_serve_mesh(2, device="cpu")
    exp, _, exp_counts = ref_greedy
    out, eng = _port(pair, "greedy", 4, 5, 0, 4, mesh=mesh)
    assert (eng.dp, eng.arena.num_shards, eng.arena.num_rows) == (2, 2, 16)
    for a, b in zip(exp, out):
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
    assert (eng.total_steps, eng.macro_launches, eng.host_syncs) == \
        exp_counts
    assert set(eng.sched_stats()["admitted_per_shard"]) == {"0", "1"}
    assert eng.arena_specs["pos"] == ("data",)
    runs = [_port(pair, "camd", 4, 6, 3, 4, noise=ReferenceNoise(0),
                  **kw) for kw in ({}, dict(mesh=mesh))]
    assert runs[0][1].arena.sizing_stalls == \
        runs[1][1].arena.sizing_stalls == 0
    for a, b in zip(runs[0][0], runs[1][0]):
        assert (a.n_candidates, a.rounds, a.tokens_spent) == \
            (b.n_candidates, b.rounds, b.tokens_spent)
        for ca, cb in zip(a.candidates, b.candidates):
            assert ca["tokens"].tolist() == cb["tokens"].tolist()


def test_macro_steps_do_not_change_streams(pair):
    """Within the port, with its own noise: CAMD streams of macro-steps of
    1, 4 and the per-token loop are equal."""
    runs = [_port(pair, "camd", 4, 5, 2, K)[0] for K in (4, 1, 0)]
    for out in runs[1:]:
        for a, b in zip(runs[0], out):
            assert [c["tokens"].tolist() for c in a.candidates] == \
                [c["tokens"].tolist() for c in b.candidates]


def test_arena_conserved_after_cancels(pair):
    """Cancels at every timing class: a queued request never prefilled, a
    prefilled one waiting in the queue, a live one, and one between CAMD
    rounds. Every request yields a result, and the arena ends with no row
    held, its allocations all freed."""
    eng = _engine(pair, "camd", 2, 4)
    for i, p in enumerate(_prompts(pair[0], 10, 5)):
        eng.submit(Request(uid=i, prompt=p))
    classes = set()
    with torch.inference_mode():
        eng.pump()
        live = {int(u) for u in eng._slot_req if u >= 0}
        queued = [r.uid for r in eng._queue]
        prefilled = [u for u in queued if u in eng._reqs]
        fresh = [u for u in queued if u not in eng._reqs]
        assert live and prefilled and fresh
        for uid, cls in ((fresh[-1], "queued"), (prefilled[0], "prefilled"),
                         (min(live), "live")):
            assert eng.cancel(uid)
            classes.add(cls)
        while eng.has_work():
            pending = [u for u, i in eng._reqs.items()
                       if i.get("pending_round") and not i["done"] and
                       u not in eng._slot_req]
            if pending and "pending round" not in classes:
                assert eng.cancel(pending[0])
                classes.add("pending round")
            eng.pump()
        results = [eng.result(u) for u in range(10)]
    assert classes == {"queued", "prefilled", "live", "pending round"}
    assert sum(r.cancelled for r in results) == 4
    eng.arena.check()
    assert eng.arena.in_use == 0
    assert eng.arena.alloc_count == eng.arena.free_count > 0


def test_paged_impl_refused(pair):
    """No layer to page: the paged impls raise, as the reference's."""
    _, _, _, model = pair
    for impl in ("paged", "paged_cuda"):
        with pytest.raises(ValueError, match="pageable"):
            ServeEngine(model, slots=2, cache_len=64, impl=impl)


def test_state_arena_lockstep_with_reference(arch):
    """A seeded sequence of alloc, share, free and misuse on two shards,
    on the port's arena and the reference's: the same rows, the same
    errors, the same stats and the same audit after every operation."""
    rng = np.random.default_rng(sum(map(ord, arch)))
    a, b = StateArena(12, num_shards=2), JArena(12, num_shards=2)
    held = []
    for _ in range(300):
        op = rng.integers(4)
        if op == 0:
            n, shard = int(rng.integers(0, 5)), int(rng.integers(2))
            ea = eb = None
            try:
                ra = a.alloc(n, shard)
            except StateArenaError:
                ea = True
            try:
                rb = b.alloc(n, shard)
            except JArenaError:
                eb = True
            assert ea == eb
            if ea is None:
                assert ra == rb
                held += ra
        elif op == 1 and held:
            rows = list(rng.choice(held, size=int(rng.integers(1, 3))))
            a.share(rows)
            b.share(rows)
            held += rows
        elif op == 2 and held:
            i = int(rng.integers(len(held)))
            a.free([held[i]])
            b.free([held[i]])
            held.pop(i)
        else:        # misuse: a row nobody holds
            free = [r for r in range(12) if r not in held]
            if free:
                r = int(rng.choice(free))
                with pytest.raises(StateArenaError):
                    a.free([r])
                with pytest.raises(JArenaError):
                    b.free([r])
        a.check()
        b.check()
        assert a.stats() == b.stats()
        assert a.best_shard() == b.best_shard()
    a.reset_stats()
    b.reset_stats()
    assert a.stats() == b.stats()
    with pytest.raises(ValueError):
        StateArena(7, num_shards=2)
