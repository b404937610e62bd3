"""Speculative decoding's units in the port against the JAX package.

- ``speculative_accept`` (``repro/sampling/samplers.py:149``) on
  synthetic logits: greedy and sampled rows, repetition penalty 1.0 and
  1.3, missing drafts (-1), EOS and limit truncation, and the vectorised
  all-greedy path against the general one. The port draws with the
  reference's own noise (``ReferenceNoise``: the Gumbel rows of global
  steps step0 + i and their ``fold_in(key, 1)`` uniforms), so tokens,
  emission, counts and stops are equal and logprobs within 1e-6.
- the engine's n-gram drafter (``engine.py:750``) on random and periodic
  histories, evidence positions at -1, at n-gram depths 1, 2 and 3:
  equal drafts.
- ``Model.decode_block`` (``model.py:205``) on the tiny model, dense ring,
  fp32 pages and int8 pages, under a partial ``valid`` mask: logits and
  hidden within 1e-5 + 1e-5|ref|, the written cache rows equal (int8
  values bit for bit; fp32 values and scales within the same tolerance:
  the two packages' GEMMs round the block's K/V projections differently)
  and every row an invalid position would write untouched. The port sends
  those writes to the quarantine page 0; the reference means to drop them,
  but its -1 page id wraps to the pool's last page (fault R6), which the
  test leaves unmapped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import PagedKVConfig as JPaged
from repro.config import SamplingConfig as JSampling
from repro.models import attention as jattn
from repro.sampling.samplers import speculative_accept as jaccept
from repro.serving import ServeEngine as JEngine
from repro_torch import config as tconfig
from repro_torch.sampling.samplers import speculative_accept
from repro_torch.serving.engine import ServeEngine
# the reference engine's draws; the fixtures: the tiny model pair and one
# torch thread (autouse)
from test_torch_engine_camd import (ReferenceNoise,  # noqa: F401
                                    _one_torch_thread, tiny)

TOL = dict(rtol=1e-5, atol=1e-5)
STEP0 = 5


def _args(B, V, *, n0=0, limit=100, seed=None):
    """Common inputs: counts, n_tok, limit, active; random counts (a few
    tokens seen) when ``seed`` is given."""
    counts = np.zeros((B, V), np.float32)
    if seed is not None:
        rng = np.random.default_rng(seed)
        for b in range(B):
            counts[b, rng.integers(0, V, 3)] += 1.0
    n_tok = np.full((B,), n0, np.int32) if np.isscalar(n0) else \
        np.asarray(n0, np.int32)
    limit = np.full((B,), limit, np.int32) if np.isscalar(limit) else \
        np.asarray(limit, np.int32)
    return dict(token_counts=counts, n_tok=n_tok, limit=limit,
                active=np.ones((B,), bool))


# the reference as its engine runs it, inside one compiled function
_jaccept = jax.jit(jaccept, static_argnames=("cfg", "eos_id",
                                             "greedy_static"))


def _both(logits, draft, cfg, greedy, *, bias=None, eos_id, static=False,
          **args):
    """(reference outputs, port outputs) of the same call, as numpy."""
    noise = ReferenceNoise(0)
    K = logits.shape[1]
    B, V = logits.shape[0], logits.shape[2]
    j = _jaccept(noise.decode_key, STEP0, jnp.asarray(logits),
                 jnp.asarray(draft), cfg=JSampling(**cfg),
                 token_counts=jnp.asarray(args["token_counts"]),
                 bias=None if bias is None else jnp.asarray(bias),
                 greedy=jnp.asarray(greedy), eos_id=eos_id,
                 n_tok=jnp.asarray(args["n_tok"]),
                 limit=jnp.asarray(args["limit"]),
                 active=jnp.asarray(args["active"]), greedy_static=static)
    t = speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(draft).long(),
        tconfig.SamplingConfig(**cfg),
        token_counts=torch.from_numpy(args["token_counts"]),
        bias=None if bias is None else torch.from_numpy(bias),
        greedy=torch.from_numpy(greedy), eos_id=eos_id,
        n_tok=torch.from_numpy(args["n_tok"]),
        limit=torch.from_numpy(args["limit"]),
        active=torch.from_numpy(args["active"]),
        noise=torch.stack([noise.step(STEP0 + i, B, V) for i in range(K)]),
        uniform=torch.stack([noise.uniform(STEP0 + i, B) for i in range(K)]),
        greedy_static=static)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _assert_same(exp, out):
    (jt, jl, je, jc, jn, js), (tt, tl, te, tc, tn, ts) = exp, out
    np.testing.assert_array_equal(je, te)
    np.testing.assert_array_equal(np.where(je, jt, -1), np.where(te, tt, -1))
    np.testing.assert_allclose(np.where(je, jl, 0.0), np.where(te, tl, 0.0),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(jc, tc)
    np.testing.assert_array_equal(jn, tn)
    np.testing.assert_array_equal(js, ts)


GREEDY = dict(temperature=0.0, repetition_penalty=1.0)


def test_accept_greedy_prefix_and_truncation_equal_reference():
    """The reference's own cases (``tests/test_speculative.py:74-118``):
    greedy rows emit argmaxes while the draft predicts them, the
    mismatch position still emitting the corrected token; tokens past the
    limit or after EOS never emit."""
    B, K, V = 2, 4, 8
    logits = np.zeros((B, K, V), np.float32)
    logits[:, :, 2] = 5.0
    draft = np.array([[2, 2, 2], [2, 6, 2]], np.int32)
    exp, out = _both(logits, draft, GREEDY, np.ones(B, bool), eos_id=V - 1,
                     **_args(B, V))
    _assert_same(exp, out)
    assert out[2].tolist() == [[True] * 4, [True, True, False, False]]
    logits = np.zeros((B, K, V), np.float32)
    logits[0, :, 2] = 5.0
    logits[1, :, V - 1] = 5.0                       # row 1's argmax is EOS
    draft = np.full((B, K - 1), 2, np.int32)
    exp, out = _both(logits, draft, GREEDY, np.ones(B, bool), eos_id=V - 1,
                     **_args(B, V, n0=[1, 0], limit=[3, 10]))
    _assert_same(exp, out)
    assert out[2].tolist() == [[True, True, False, False],
                               [True, False, False, False]]
    assert out[5].tolist() == [True, True]


@pytest.mark.parametrize("rep", [1.0, 1.3])
def test_accept_sampled_rows_equal_reference(rep):
    """Sampled and greedy rows together, against the reference's general
    path under its own keys: drafts that are likely (the row's argmax),
    unlikely, missing, and the EOS token; per-row limits that cut the
    block; seen tokens under the repetition penalty; a CAMD bias."""
    B, K, V = 8, 5, 16
    rng = np.random.default_rng(7)
    logits = (2.0 * rng.standard_normal((B, K, V))).astype(np.float32)
    eos = 3
    draft = np.argmax(logits[:, :-1], -1).astype(np.int32)  # likely
    draft[1] = rng.integers(0, V, K - 1)                     # random
    draft[2, 1:] = -1                                        # one draft
    draft[3, 2] = eos
    logits[3, 2, eos] += 8.0                                 # EOS accepted
    draft[5] = -1                                            # none
    greedy = np.array([0, 0, 0, 0, 0, 1, 1, 0], bool)
    bias = (0.5 * rng.standard_normal((B, V))).astype(np.float32)
    cfg = dict(temperature=0.8, top_p=0.9, top_k=0, repetition_penalty=rep)
    args = _args(B, V, n0=[1, 2, 1, 3, 1, 1, 4, 5],
                 limit=[9, 9, 9, 9, 9, 9, 6, 7], seed=1)
    exp, out = _both(logits, draft, cfg, greedy, bias=bias, eos_id=eos,
                     **args)
    _assert_same(exp, out)
    emit = out[2]
    assert emit[:, 1].sum() >= 3, emit       # some drafts were accepted
    assert not emit[:, 1:].all(), emit       # and some rejected or cut


@pytest.mark.parametrize("rep", [1.0, 1.3])
def test_accept_greedy_static_equal_reference(rep):
    """The vectorised all-greedy path against the reference's, and against
    the port's general path (``tests/test_speculative.py:121``): a perfect
    draft, a mismatch, a missing draft, limits that bite."""
    B, K, V = 4, 5, 16
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((B, K, V)).astype(np.float32)
    draft = np.argmax(logits, -1)[:, 1:].astype(np.int32)
    draft[1, 2] = (draft[1, 2] + 1) % V
    draft[2, 0] = -1
    cfg = dict(temperature=0.7, top_p=0.9, top_k=5, repetition_penalty=rep)
    args = _args(B, V, n0=1, limit=4, seed=2)
    greedy = np.ones(B, bool)
    exp, out = _both(logits, draft, cfg, greedy, eos_id=V, static=True,
                     **args)
    _assert_same(exp, out)
    _, general = _both(logits, draft, cfg, greedy, eos_id=V, static=False,
                       **args)
    _assert_same(out, general)


# ---------------------------------------------------------------------------
# the n-gram drafter
# ---------------------------------------------------------------------------

def _engines(tiny, ngram, spec_k=4):
    jcfg, jmodel, jparams, model = tiny
    kw = dict(slots=6, cache_len=64, spec_k=spec_k, spec_ngram=ngram,
              mode="greedy", macro_steps=8)
    return (JEngine(jmodel, jparams, impl="paged",
                    paged_kv=JPaged(page_size=8), **kw),
            ServeEngine(model, impl="paged",
                        paged_kv=tconfig.PagedKVConfig(page_size=8), **kw))


def _histories(H=64, seed=0):
    """Six rows: random over a small alphabet (many matches), periodic
    with periods 3 and 5 (a full-width match behind the tail), a row with
    evidence positions (-1) ahead of its prompt, one of all-distinct
    tokens and one where only the pending token's 1-gram matches. Returns
    (hist, pos, last)."""
    rng = np.random.default_rng(seed)
    hist = np.full((6, H), -1, np.int64)
    pos = np.array([40, 30, 27, 50, 9, 21])
    hist[0, :40] = rng.integers(2, 6, 40)
    hist[1, :30] = np.tile([7, 8, 9], 10)
    hist[2, :27] = np.tile([4, 5, 6, 7, 5], 6)[:27]
    hist[3, 16:50] = rng.integers(2, 5, 34)             # 16 evidence rows
    hist[4, :9] = np.arange(10, 19)
    hist[5, :21] = rng.integers(20, 30, 21)
    last = np.array([hist[0, 38], 7, 4, 3, 40, hist[5, 3]])
    return hist, pos, last


@pytest.mark.parametrize("ngram", [1, 2, 3])
def test_ngram_draft_equal_reference(tiny, ngram):
    jeng, eng = _engines(tiny, ngram)
    for seed in (0, 1):
        hist, pos, last = _histories(seed=seed)
        exp = np.asarray(jeng._ngram_draft(jnp.asarray(hist, jnp.int32),
                                           jnp.asarray(pos, jnp.int32),
                                           jnp.asarray(last, jnp.int32)))
        out = eng._ngram_draft(torch.from_numpy(hist), torch.from_numpy(pos),
                               torch.from_numpy(last)).numpy()
        np.testing.assert_array_equal(exp, out)
        assert (out >= 0).any() and (out < 0).any()
    # the reference's examples: a deep full-width match behind the tail,
    # no match at all
    hist = np.full((2, 64), -1, np.int64)
    hist[0, :8] = [1, 2, 3, 1, 2, 3, 1, 2]
    hist[1, :5] = [5, 6, 7, 8, 9]
    out = eng._ngram_draft(torch.from_numpy(hist), torch.tensor([8, 5]),
                           torch.tensor([2, 9]))
    assert out.tolist() == [[3, 1, 2], [-1, -1, -1]]


# ---------------------------------------------------------------------------
# block verification
# ---------------------------------------------------------------------------

def _close(exp, out):
    np.testing.assert_allclose(np.asarray(exp, np.float32),
                               out.float().numpy(), **TOL)


@pytest.mark.parametrize("kind", ["dense", "paged", "int8"])
def test_decode_block_equals_reference(tiny, kind):
    """A 4-token block on three rows at positions 5, 17 and 30 of random
    cached K/V, row 1 valid for two positions, row 2 for none."""
    jcfg, jmodel, jparams, model = tiny
    rng = np.random.default_rng(4)
    B, S, Sc, ps = 3, 4, 48, 8
    n = Sc // ps
    P = B * n + 2                  # page P - 1 is mapped by no row
    pos = np.array([5, 17, 30], np.int32)
    valid = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [0, 0, 0, 0]], bool)
    toks = rng.integers(2, jcfg.vocab_size, (B, S)).astype(np.int32)
    nL, Hkv, hd = jcfg.num_layers, jcfg.num_kv_heads, jcfg.resolved_head_dim
    if kind == "dense":
        kv = rng.standard_normal((2, nL, B, Sc, Hkv, hd)).astype(np.float32)
        jc = {"super": ({"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1])},),
              "tail": (), "pos": jnp.asarray(pos)}
        tc = model.make_cache(B, Sc)
        tc["k"].copy_(torch.from_numpy(kv[0]))
        tc["v"].copy_(torch.from_numpy(kv[1]))
    else:
        kv = rng.standard_normal((2, nL, P, ps, Hkv, hd)).astype(np.float32)
        bt = (1 + rng.permutation(P - 2)[:B * n]).reshape(B, n)
        bt = bt.astype(np.int32)
        jleaf = {"k_pages": jnp.asarray(kv[0]), "v_pages": jnp.asarray(kv[1])}
        tc = model.make_paged_cache(B, Sc, page_size=ps, num_pages=P,
                                    kv_dtype="auto" if kind == "paged"
                                    else kind)
        if kind == "int8":
            qd = jattn.kv_storage_dtype(kind, jnp.float32)[0]
            jleaf = {}
            for name, x in (("k", kv[0]), ("v", kv[1])):
                q, sc = jattn.kv_quantize(jnp.asarray(x), qd)
                jleaf[f"{name}_pages"], jleaf[f"{name}_scale"] = q, sc
                tc[f"{name}_pages"].copy_(torch.from_numpy(np.array(q)))
                tc[f"{name}_scale"].copy_(torch.from_numpy(np.array(sc)))
        else:
            tc["k_pages"].copy_(torch.from_numpy(kv[0]))
            tc["v_pages"].copy_(torch.from_numpy(kv[1]))
        jc = {"super": (jleaf,), "tail": (), "pos": jnp.asarray(pos),
              "block_table": jnp.asarray(bt)}
        tc["block_table"].copy_(torch.from_numpy(bt))
    tc["pos"].copy_(torch.from_numpy(pos))
    before = {k: v.clone() for k, v in tc.items()}
    jl, jh, jc = jmodel.decode_block(jparams, jnp.asarray(toks), jc,
                                     jnp.asarray(valid))
    with torch.inference_mode():
        tl, th, tc = model.decode_block(torch.from_numpy(toks).long(), tc,
                                        torch.from_numpy(valid))
    assert tl.shape == (B, S, jcfg.vocab_size)
    _close(jl, tl)
    _close(jh, th)
    assert torch.equal(tc["pos"], before["pos"])          # not advanced
    leaves = ("k", "v") if kind == "dense" else \
        [k for k in tc if k.endswith(("_pages", "_scale"))]
    for name in leaves:
        exp, got = np.asarray(jc["super"][0][name]), tc[name].numpy()
        if kind != "dense":
            # the port sends dropped writes to page 0, which no row maps;
            # the reference's land on page P - 1 (fault R6: its -1 page id
            # wraps), which no row maps here either
            assert np.array_equal(got[:, P - 1], before[name][:, P - 1])
            exp, got = exp[:, 1:P - 1], got[:, 1:P - 1]
        # the rows written equal, every row an invalid position would
        # write untouched: int8 values bit for bit, fp32 values and scales
        # to the logits' tolerance (the two packages' GEMMs round a
        # 4-token block's K/V projections differently, by ~2e-6)
        if exp.dtype == np.int8:
            np.testing.assert_array_equal(exp, got)
        else:
            np.testing.assert_allclose(exp, got, **TOL)
    # the valid positions were written, the invalid ones not
    for b in range(B):
        for i in range(S):
            p = int(pos[b]) + i
            if kind == "dense":
                row, was = tc["k"][:, b, p], before["k"][:, b, p]
            else:
                page = int(bt[b, p // ps])
                row = tc["k_pages"][:, page, p % ps]
                was = before["k_pages"][:, page, p % ps]
            assert torch.equal(row, was) != bool(valid[b, i]), (b, i)
