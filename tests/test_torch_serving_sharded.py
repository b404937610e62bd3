"""Mesh-parallel serving of the port against the JAX single-device engine:
the differential grid.

The reference's contract (``tests/test_serving_sharded.py``): sharding is
a placement decision, never a numerics or scheduling decision. The port
serves a mesh as dp logical data shards on one device
(``make_serve_mesh(dp, device="cpu")``), the counterpart of the
reference's forced host devices, so this suite runs in every CPU run.
It reuses ``tests/data/make_golden_fifo.py``'s tiny model and workload,
loaded as the reference suite loads it; the reference's weights carry
over and its Gumbel draws drive the port (``ReferenceNoise``).

Here the port's engine at dp 2 and dp 4 gives the JAX single-device
engine's streams byte for byte (tokens, tokens spent, rounds, candidates)
over impls torch and paged, modes camd and best_of_n and K 0 and 8, and
ends with its pool conserved and no reservation left. The policies, the
prefix cache, disaggregated chunked prefill, the front-end and the
shard-local checks are in ``test_torch_serving_sharded_features.py``.
"""
import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from repro_torch import config as tconfig
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServeEngine
from test_torch_engine_camd import ReferenceNoise, _one_torch_thread  # noqa

_spec = importlib.util.spec_from_file_location(
    "make_golden_fifo",
    os.path.join(os.path.dirname(__file__), "data", "make_golden_fifo.py"))
_gold_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gold_mod)
make_engine, submit, tiny_model = (_gold_mod.make_engine, _gold_mod.submit,
                                   _gold_mod.tiny_model)

PORT_IMPL = {"xla": "torch", "paged": "paged"}
CAMD = dict(samples_per_round=2, max_rounds=2, min_samples=2, max_clusters=8)


@pytest.fixture(scope="module")
def model3():
    """The golden harness's tiny model: the reference's (cfg, model,
    params) and the port's model with its weights."""
    jcfg, jmodel, jparams = tiny_model()
    cfg = tconfig.ModelConfig(**{f.name: getattr(jcfg, f.name) for f in
                                 dataclasses.fields(tconfig.ModelConfig)})
    model = build_model(cfg, torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg))
    return jcfg, jmodel, jparams, model


def port_engine(model, *, mode, impl, macro_steps, dp=0, **kw):
    """``make_engine``'s settings on the port, at ``dp`` logical shards
    (0: no mesh), with the reference's noise."""
    defaults = dict(
        slots=4, cache_len=32,
        sampling=tconfig.SamplingConfig(max_new_tokens=6, temperature=0.8),
        camd=tconfig.CAMDConfig(**CAMD), n_candidates=3, max_new_tokens=6,
        eos_id=1, seed=0, paged_kv=tconfig.PagedKVConfig(page_size=8),
        noise=ReferenceNoise(0, legacy=macro_steps == 0),
        mesh=make_serve_mesh(dp, device="cpu") if dp else None)
    defaults.update(kw)
    return ServeEngine(model, mode=mode, impl=PORT_IMPL.get(impl, impl),
                       macro_steps=macro_steps, **defaults)


def _streams(res):
    return [{"uid": r.uid, "tokens": np.asarray(r.tokens).tolist(),
             "tokens_spent": r.tokens_spent, "rounds": r.rounds,
             "n_candidates": r.n_candidates,
             "candidates": sorted(np.asarray(c["tokens"]).tolist()
                                  for c in r.candidates)}
            for r in sorted(res, key=lambda r: r.uid)]


def _port_run(eng, requests):
    for r in requests:
        eng.submit(r)
    with torch.inference_mode():
        return _streams(eng.run())


def _conserved(eng):
    if eng.paged:
        eng.pool.check()
        assert eng.pool.in_use == (len(eng.pool.prefix._nodes)
                                   if eng.pool.prefix else 0)
        assert eng._reserved == 0 and not eng._reserved_sh.any()


_REF = {}


def _reference(model3, n=2, **kw):
    """The JAX single-device engine's streams, once a module a setting."""
    key = (n,) + tuple(sorted(kw.items()))
    if key not in _REF:
        cfg, jmodel, jparams, _ = model3
        eng = make_engine(jmodel, jparams, **kw)
        submit(eng, cfg, n=n)
        _REF[key] = _streams(eng.run())
    return _REF[key]


def _golden_requests(cfg, n, plen=5):
    """``make_golden_fifo.submit``'s requests, for the port."""
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(
        2, cfg.vocab_size, plen).astype(np.int32)) for i in range(n)]


# ---------------------------------------------------------------------------
# the differential grid: {torch, paged} x {camd, best_of_n} x K {0, 8}
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "paged"])
@pytest.mark.parametrize("mode", ["camd", "best_of_n"])
@pytest.mark.parametrize("k", [0, 8])
def test_sharded_streams_equal_reference(model3, impl, mode, k):
    ref = _reference(model3, mode=mode, impl=impl, macro_steps=k)
    for dp in (2, 4):
        eng = port_engine(model3[3], mode=mode, impl=impl, macro_steps=k,
                          dp=dp)
        assert (eng.dp, eng.slots_per_shard) == (dp, 4 // dp)
        got = _port_run(eng, _golden_requests(model3[0], 2))
        assert got == ref, f"{mode}/{impl}/K{k} diverged at dp {dp}"
        _conserved(eng)
