"""The port's serving engine against the JAX package's: sampled streams.

The port's engine takes its Gumbel noise from a source object; here the
source reproduces the reference engine's own draws — ``split(self.key)``
at admission (``engine.py:1590``), ``fold_in(decode_key, t)`` per fused
step (``engine.py:333, :722``) and ``split(self.key)`` per legacy step —
so CAMD-mode streams, candidate counts and round counts must equal the
reference's token for token, dense and paged. Also: the port's page-pool
copy keeps its invariants, features of later slices raise (the prefix
cache and chunked prefill are off on dense impls, as in the reference;
speculation needs the macro body), and a text-only model refuses
multimodal requests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CAMDConfig as JCAMD
from repro.config import PagedKVConfig as JPaged
from repro.config import SamplingConfig as JSampling
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JEngine
from repro_torch import config as tconfig
from repro_torch.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.page_pool import PagePool, PagePoolError
from torch_ranks import _one_torch_thread  # noqa: F401


class ReferenceNoise:
    """The reference engine's Gumbel draws, as the port's noise source."""

    def __init__(self, seed: int, legacy: bool = False):
        self.key = jax.random.PRNGKey(seed)
        self.decode_key = jax.random.fold_in(jax.random.PRNGKey(seed),
                                             0x6d6163)
        self.legacy = legacy

    @staticmethod
    def _gumbel(key, shape):
        return torch.from_numpy(np.array(jax.random.gumbel(key, shape,
                                                           jnp.float32)))

    def first(self, n, vocab):
        self.key, *keys = jax.random.split(self.key, n + 1)
        return torch.cat([self._gumbel(k, (1, vocab)) for k in keys])

    def step(self, t, batch, vocab):
        if self.legacy:
            self.key, k = jax.random.split(self.key)
        else:
            k = jax.random.fold_in(self.decode_key, t)
        return self._gumbel(k, (batch, vocab))

    def uniform(self, t, batch):
        """A speculative step's acceptance draws: ``uniform(fold_in(key,
        1))`` of step t's key (``repro/sampling/samplers.py:217``)."""
        k = jax.random.fold_in(jax.random.fold_in(self.decode_key, t), 1)
        return torch.from_numpy(np.array(jax.random.uniform(k, (batch,))))


@pytest.fixture(scope="module")
def tiny(tiny_model):
    jcfg, jmodel, jparams = tiny_model
    cfg = tconfig.ModelConfig(**{f.name: getattr(jcfg, f.name) for f in
                                 dataclasses.fields(tconfig.ModelConfig)})
    model = build_model(cfg, torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg))
    return jcfg, jmodel, jparams, model


def _kw(cfg, mode, K, sched):
    return dict(slots=6, cache_len=64, mode=mode, n_candidates=3,
                max_new_tokens=8, eos_id=cfg.vocab_size, seed=0,
                macro_steps=K, sched_policy=sched)


def _submit(eng, req_cls, cfg):
    rng = np.random.default_rng(1)
    for i, n in enumerate((6, 9, 6, 20)):
        eng.submit(req_cls(uid=i, prompt=rng.integers(
            2, cfg.vocab_size, n).astype(np.int32)))


@pytest.mark.parametrize("ref_impl,impl,mode,K,sched", [
    ("xla", "torch", "camd", 8, "fifo"),
    ("paged", "paged", "camd", 8, "coverage"),
    ("xla", "torch", "camd", 0, "fifo"),
    ("paged", "paged", "self_consistency", 1, "fifo"),
])
def test_sampled_streams_equal_reference(tiny, ref_impl, impl, mode, K,
                                         sched):
    jcfg, jmodel, jparams, model = tiny
    camd = dict(samples_per_round=2, max_rounds=3, min_samples=2,
                max_clusters=8)
    jeng = JEngine(jmodel, jparams, impl=ref_impl,
                   paged_kv=JPaged(page_size=8),
                   sampling=JSampling(max_new_tokens=8, temperature=0.8),
                   camd=JCAMD(**camd), **_kw(jcfg, mode, K, sched))
    _submit(jeng, JRequest, jcfg)
    exp = sorted(jeng.run(), key=lambda r: r.uid)
    eng = ServeEngine(model, impl=impl,
                      paged_kv=tconfig.PagedKVConfig(page_size=8),
                      sampling=tconfig.SamplingConfig(max_new_tokens=8,
                                                      temperature=0.8),
                      camd=tconfig.CAMDConfig(**camd),
                      noise=ReferenceNoise(0, legacy=K == 0),
                      **_kw(jcfg, mode, K, sched))
    _submit(eng, Request, jcfg)
    with torch.inference_mode():
        out = sorted(eng.run(), key=lambda r: r.uid)
    assert len(out) == len(exp) == 4
    for a, b in zip(exp, out):
        assert (a.n_candidates, a.rounds, a.tokens_spent,
                a.stopped_early) == (b.n_candidates, b.rounds,
                                     b.tokens_spent, b.stopped_early)
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
        for ca, cb in zip(a.candidates, b.candidates):
            assert ca["tokens"].tolist() == cb["tokens"].tolist()
            assert ca["cluster"] == cb["cluster"]
            np.testing.assert_allclose(ca["score"], cb["score"], rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(a.p_star, b.p_star, rtol=1e-5, atol=1e-5)
    if mode == "camd":
        assert sum(r.rounds for r in out) > len(out)  # some went again
    assert (eng.total_steps, eng.macro_launches, eng.host_syncs) == \
        (jeng.total_steps, jeng.macro_launches, jeng.host_syncs)
    if eng.paged:
        eng.pool.check()
        assert eng.pool.in_use == 0 and eng._reserved == 0


def test_page_pool_copy_invariants():
    pool = PagePool(6, 4)
    a = pool.alloc(2)
    assert a == [1, 2]                        # ascending, page 0 reserved
    pool.share(a)
    pool.free(a)
    assert pool.in_use == 2
    fr = pool.stage_frontier(2)
    pool.return_frontier(fr[1:])
    pool.free(a + fr[:1])
    pool.check()
    assert pool.in_use == 0 and pool.frontier_returned == 1
    for bad in (lambda: pool.free([1]), lambda: pool.free([0]),
                lambda: pool.share([3]), lambda: pool.alloc(6),
                lambda: PagePool(1, 4)):
        with pytest.raises(PagePoolError):
            bad()


def test_later_slices_raise(tiny):
    _, _, _, model = tiny
    # mesh serving is served now on logical shards of one device
    # (tests/test_torch_serving_sharded.py); a mesh with a model axis or
    # over several devices is a later slice
    from repro_torch.launch.mesh import ServeMesh, make_serve_mesh
    cpu = torch.device("cpu")
    for mesh in (make_serve_mesh(2, model=2, device="cpu"),
                 ServeMesh({"data": 2, "model": 1}, ("data", "model"),
                           (cpu, torch.device("cuda", 1)))):
        with pytest.raises(NotImplementedError):
            ServeEngine(model, cache_len=64, mesh=mesh)
    # disaggregation needs a paged impl, and at most dp prefill shards
    for kw in (dict(prefill_shards=1), dict(impl="paged", prefill_shards=2)):
        with pytest.raises(ValueError):
            ServeEngine(model, cache_len=64, **kw)
    assert ServeEngine(model, cache_len=64, impl="paged",
                       prefill_shards=1).prefill_shards == 1
    # speculative decoding is served now (tests/test_torch_engine_spec.py),
    # inside the macro body only
    assert ServeEngine(model, cache_len=64, impl="paged", spec_k=4).spec
    with pytest.raises(ValueError, match="macro_steps"):
        ServeEngine(model, cache_len=64, impl="paged", macro_steps=0,
                    spec_k=4)
    # the prefix cache and chunked prefill are served now
    # (tests/test_torch_prefix_cache.py, test_torch_prefill_chunked.py);
    # on a dense impl they are quietly off, as in the reference
    eng = ServeEngine(model, cache_len=64, prefix_cache=True,
                      prefill_chunk=16)
    assert eng.prefix_cache is False and eng.chunked is False
    eng = ServeEngine(model, cache_len=64, impl="paged", prefix_cache=True,
                      prefill_chunk=16)
    assert eng.prefix_cache is True and eng.chunked is True
    # quantized pools are served now (tests/test_torch_engine_quantized.py)
    ServeEngine(model, cache_len=64, impl="paged",
                paged_kv=tconfig.PagedKVConfig(kv_dtype="int8"))
    eng = ServeEngine(model, cache_len=64)
    # multimodal requests are served now, but not by a text-only model
    with pytest.raises(ValueError, match="evidence"):
        eng.submit(Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                           evidence=np.zeros((2, 4), np.float32)))
    with pytest.raises(ValueError, match="vision"):
        eng.submit(Request(uid=1, prompt=np.arange(4, dtype=np.int32),
                           image=np.zeros((8, 8, 3), np.float32)))
    # cancellation is served now (tests/test_torch_cancellation.py): a uid
    # the engine never saw is not cancelled
    assert eng.cancel(0) is False
