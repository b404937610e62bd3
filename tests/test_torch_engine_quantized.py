"""The port's serving engine on int8/fp8 KV pools against the JAX
package's.

Both engines seed a request's prompt pages by quantizing the prompt span
once and broadcasting values and scales to the copy-on-write tail copies,
and quantize each decoded row on write; the ``paged`` impls read the pool
through the same dequantizing gather. So on ``tiny_model``, with the
reference engine's own Gumbel draws (``ReferenceNoise``) at page size 16:
the seeded pages and scales are bitwise equal (fp8 compared as bytes),
greedy and CAMD streams are equal token for token, and ``kv_stats`` gives
the reference's byte accounting (values plus scales). On the port alone:
an fp32 pool is byte-identical to "auto" on an fp32 model, int8 streams do
not depend on the macro-step count, and misuse raises the reference's
``ValueError``s.
"""
import numpy as np
import pytest
import torch

from repro.config import CAMDConfig as JCAMD
from repro.config import PagedKVConfig as JPaged
from repro.config import SamplingConfig as JSampling
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JEngine
from repro_torch import config as tconfig
from repro_torch.serving.engine import Request, ServeEngine
# the reference engine's Gumbel draws; the fixtures: the tiny model pair
# and one torch thread (autouse)
from test_torch_engine_camd import (ReferenceNoise,  # noqa: F401
                                    _one_torch_thread, tiny)

CAMD = dict(samples_per_round=2, max_rounds=3, min_samples=2,
            max_clusters=8)
PS = 16
# prompts of 6 and 9 tokens (a tail page only), 20 and 17 (a full prompt
# page shared by the candidates, plus the tail copies)
PROMPT_LENS = (6, 9, 20, 17)
STATS = ("bytes_per_page", "resident_kv_bytes", "peak_kv_bytes",
         "dense_equiv_bytes")


def _kw(cfg, mode, K):
    return dict(slots=6, cache_len=64, mode=mode, n_candidates=3,
                max_new_tokens=8, eos_id=cfg.vocab_size, seed=0,
                macro_steps=K)


def _submit(eng, req_cls, cfg):
    rng = np.random.default_rng(1)
    for i, n in enumerate(PROMPT_LENS):
        eng.submit(req_cls(uid=i, prompt=rng.integers(
            2, cfg.vocab_size, n).astype(np.int32)))


def _port(model, cfg, kv_dtype, mode="camd", K=8):
    return ServeEngine(model, impl="paged",
                       paged_kv=tconfig.PagedKVConfig(page_size=PS,
                                                      kv_dtype=kv_dtype),
                       sampling=tconfig.SamplingConfig(max_new_tokens=8,
                                                       temperature=0.8),
                       camd=tconfig.CAMDConfig(**CAMD),
                       noise=ReferenceNoise(0), **_kw(cfg, mode, K))


def _bytes(x):
    """A pool leaf's bytes, fp8 included."""
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.itemsize == 1 else x


def _pools(cache):
    return {k: _bytes(cache[k].view(torch.uint8) if cache[k].dtype ==
                      torch.float8_e4m3fn else cache[k])
            for k in ("k_pages", "v_pages", "k_scale", "v_scale")}


def _jax_pools(cache):
    (entry,) = cache["super"]            # every layer an attention layer
    return {k: _bytes(entry[k]) for k in ("k_pages", "v_pages", "k_scale",
                                          "v_scale")}


def _streams(res):
    return [[c["tokens"].tolist() for c in r.candidates] for r in res]


def _reseed_from(eng, jeng):
    """Write ``jeng``'s prefill rows into ``eng``'s zeroed pools through
    the port's own seeding (``_write_pages``): each request's full prompt
    pages, then its candidates' tail copies by one broadcast."""
    cache = eng.state.cache
    for k in ("k_pages", "v_pages", "k_scale", "v_scale"):
        cache[k].zero_()
    ps = eng.page_size
    for uid, info in eng._reqs.items():
        if not info.get("prompt_seeded"):        # not admitted yet
            continue
        jrow = jeng._reqs[uid]["cache_row"]["super"][0]
        row = info["cache_row"]
        for k in ("k", "v"):
            row[k].copy_(torch.from_numpy(np.array(jrow[k])))
        full, tail_len = divmod(info["prompt_len"], ps)
        eng._write_pages(row, info["prompt_pages"], 0)
        tails = [eng._slot_pages[s][full] for s in range(eng.B)
                 if eng._slot_req[s] == uid and tail_len]
        eng._write_pages(row, tails, full * ps, broadcast=True)


@pytest.mark.parametrize("mode", ["greedy", "camd"])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_engine_equals_reference(tiny, kv_dtype, mode):
    """After the first scheduling pass both engines hold the same pages;
    seeded from the same prefill rows (the reference's), the port's pool
    values and scales equal the reference's bit for bit. Then equal
    streams, rounds, p*, telemetry and byte accounting, and no page
    leaked."""
    jcfg, jmodel, jparams, model = tiny
    jeng = JEngine(jmodel, jparams, impl="paged",
                   paged_kv=JPaged(page_size=PS, kv_dtype=kv_dtype),
                   sampling=JSampling(max_new_tokens=8, temperature=0.8),
                   camd=JCAMD(**CAMD), **_kw(jcfg, mode, 8))
    eng, seeded = (_port(model, jcfg, kv_dtype, mode) for _ in range(2))
    for e, req_cls in ((jeng, JRequest), (eng, Request), (seeded, Request)):
        _submit(e, req_cls, jcfg)
    jeng._schedule()
    with torch.inference_mode():
        seeded._schedule()
        assert seeded._slot_pages == jeng._slot_pages
        assert seeded.pool.in_use == jeng.pool.in_use > 0
        _reseed_from(seeded, jeng)
    exp_pools, got_pools = _jax_pools(jeng.state.cache), \
        _pools(seeded.state.cache)
    for k in exp_pools:
        np.testing.assert_array_equal(got_pools[k], exp_pools[k], err_msg=k)
    assert got_pools["k_pages"].any() and got_pools["k_scale"].any()

    jeng_run = jeng.run()         # continues from its first pass
    with torch.inference_mode():
        eng._schedule()           # the same passes as the reference's
        out = sorted(eng.run(), key=lambda r: r.uid)
    exp = sorted(jeng_run, key=lambda r: r.uid)
    assert len(out) == len(exp) == len(PROMPT_LENS)
    assert _streams(out) == _streams(exp)
    for a, b in zip(exp, out):
        assert (a.n_candidates, a.rounds, a.tokens_spent) == \
            (b.n_candidates, b.rounds, b.tokens_spent)
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
        np.testing.assert_allclose(a.p_star, b.p_star, rtol=1e-5, atol=1e-5)
    assert (eng.total_steps, eng.macro_launches, eng.host_syncs) == \
        (jeng.total_steps, jeng.macro_launches, jeng.host_syncs)
    js, ts = jeng.kv_stats(), eng.kv_stats()
    assert ts["kv_dtype"] == js["kv_dtype"] == kv_dtype
    assert {k: ts[k] for k in STATS} == {k: js[k] for k in STATS}
    # hd 16: 16 one-byte values + a 4-byte scale per token, head, K or V
    L, Hkv, hd = jcfg.num_layers, jcfg.num_kv_heads, jcfg.resolved_head_dim
    assert ts["bytes_per_page"] == 2 * L * PS * Hkv * (hd + 4)
    eng.pool.check()
    assert eng.pool.in_use == 0 and eng._reserved == 0


def test_fp32_pool_byte_identical_to_auto(tiny):
    """On an fp32 model, "fp32" and "auto" store the same pool: the same
    streams and the same pool bytes at the end of the run."""
    jcfg, _, _, model = tiny
    runs = {}
    for kv_dtype in ("auto", "fp32"):
        eng = _port(model, jcfg, kv_dtype)
        _submit(eng, Request, jcfg)
        with torch.inference_mode():
            res = sorted(eng.run(), key=lambda r: r.uid)
        assert eng.state.cache["k_pages"].dtype == torch.float32
        assert "k_scale" not in eng.state.cache
        runs[kv_dtype] = (_streams(res), eng.state.cache, eng.kv_stats())
    assert runs["auto"][0] == runs["fp32"][0]
    for k in ("k_pages", "v_pages"):
        assert torch.equal(runs["auto"][1][k], runs["fp32"][1][k])
    assert runs["auto"][2]["bytes_per_page"] == \
        runs["fp32"][2]["bytes_per_page"]


def test_int8_streams_do_not_depend_on_macro_steps(tiny):
    """The same quantized pool feeds every partition of the decode loop:
    K 4 and K 8 give the same candidates' streams."""
    jcfg, _, _, model = tiny
    outs = []
    for K in (4, 8):
        eng = _port(model, jcfg, "int8", K=K)
        _submit(eng, Request, jcfg)
        with torch.inference_mode():
            outs.append(_streams(sorted(eng.run(), key=lambda r: r.uid)))
    assert outs[0] == outs[1]


def test_quantized_pool_misuse_raises(tiny):
    """The reference's refusals: a quantized pool needs a paged impl, and
    an unknown storage name is refused."""
    jcfg, _, _, model = tiny
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(model, impl="torch", cache_len=64,
                    paged_kv=tconfig.PagedKVConfig(kv_dtype="int8"))
    with pytest.raises(ValueError, match="kv_dtype"):
        ServeEngine(model, impl="paged", cache_len=64,
                    paged_kv=tconfig.PagedKVConfig(kv_dtype="int4"))
