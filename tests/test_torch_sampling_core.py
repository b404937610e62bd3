"""The port's samplers and CAMD core against the JAX package, on the CPU.

Samplers get the reference's own Gumbel draws injected (a sampled token
is argmax(processed + gumbel) in both), so tokens must be equal and
logprobs agree within 1e-5. ``round_update_assign`` folds the same rounds
of candidates into both packages' CAMD state; every field must agree
(integers exactly, floats within 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CAMDConfig as JCAMD
from repro.config import SamplingConfig as JSampling
from repro.core import controller as jctrl
from repro.core import scoring as jscoring
from repro.sampling import samplers as jsamp
from repro_torch.config import CAMDConfig, SamplingConfig
from repro_torch.core import controller as tctrl
from repro_torch.core import scoring as tscoring
from repro_torch.sampling import samplers as tsamp
from torch_ranks import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
CONFIGS = [
    dict(),                                               # engine default
    dict(temperature=0.8, top_p=1.0, repetition_penalty=1.0),
    dict(temperature=1.3, top_k=5, top_p=0.8, min_p=0.05),
    dict(temperature=0.0),                                # greedy
]


def t(x):
    return torch.from_numpy(np.array(x))


def _logits(rng, B, V, ties=False):
    lg = rng.standard_normal((B, V)).astype(np.float32) * 3
    if ties:                         # duplicated kth values for top-k
        lg[:, :8] = 2.5
    return lg


@pytest.mark.parametrize("kw", CONFIGS)
def test_process_logits_matches(kw):
    rng = np.random.default_rng(0)
    B, V = 4, 97
    lg = _logits(rng, B, V, ties=True)
    counts = (rng.random((B, V)) < 0.1).astype(np.float32)
    bias = rng.standard_normal((B, V)).astype(np.float32) * 0.1
    exp = jsamp.process_logits(jnp.asarray(lg), JSampling(**kw),
                               jnp.asarray(counts), jnp.asarray(bias))
    out = tsamp.process_logits(t(lg), SamplingConfig(**kw), t(counts),
                               t(bias))
    np.testing.assert_allclose(np.asarray(exp), out.numpy(), **TOL)


def test_top_k_keeps_exactly_k_under_ties():
    lg = np.zeros((2, 20), np.float32)
    lg[:, 3:9] = 1.0                  # six tied maxima, keep 4
    exp = jsamp.apply_top_k(jnp.asarray(lg), 4)
    out = tsamp.apply_top_k(t(lg), 4)
    assert int((out > -1e29).sum()) == 8
    np.testing.assert_array_equal(np.asarray(exp), out.numpy())


@pytest.mark.parametrize("kw", CONFIGS)
def test_sample_token_with_reference_noise(kw):
    rng = np.random.default_rng(1)
    B, V = 6, 128
    lg = _logits(rng, B, V)
    counts = (rng.random((B, V)) < 0.05).astype(np.float32)
    greedy = np.array([False, True] * 3)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        jt, jl = jsamp.sample_token(key, jnp.asarray(lg), JSampling(**kw),
                                    jnp.asarray(counts),
                                    greedy=jnp.asarray(greedy))
        noise = t(jax.random.gumbel(key, (B, V), jnp.float32))
        tt, tl = tsamp.sample_token(t(lg), SamplingConfig(**kw), t(counts),
                                    greedy=t(greedy), noise=noise)
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), **TOL)


def test_sample_token_batch_with_reference_noise():
    rng = np.random.default_rng(2)
    V, n = 64, 5
    lg = _logits(rng, 1, V)
    bias = rng.standard_normal((1, V)).astype(np.float32)
    cfg = dict(temperature=0.8)
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    for greedy in (False, True):
        jt, jl = jsamp.sample_token_batch(keys, jnp.asarray(lg),
                                          JSampling(**cfg), jnp.asarray(bias),
                                          jnp.asarray([greedy]))
        noise = torch.stack([t(jax.random.gumbel(k, (1, V), jnp.float32))[0]
                             for k in keys])
        tt, tl = tsamp.sample_token_batch(t(lg), SamplingConfig(**cfg),
                                          t(bias), torch.tensor([greedy]),
                                          noise=noise)
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), **TOL)


def test_gumbel_noise_is_a_function_of_seed_and_step():
    a = tsamp.GumbelNoise(5, "cpu")
    b = tsamp.GumbelNoise(5, "cpu")
    assert torch.equal(a.step(7, 2, 9), b.step(7, 2, 9))
    assert not torch.equal(a.step(7, 2, 9), a.step(8, 2, 9))
    assert not torch.equal(a.first(2, 9), a.first(2, 9))   # per admission
    u = torch.tensor([0.0, 0.5, 1.0 - 2 ** -24])
    assert torch.isfinite(tsamp.gumbel(u)).all()


def test_scoring_matches():
    rng = np.random.default_rng(4)
    lp = -rng.random((3, 7)).astype(np.float32)
    mask = (rng.random((3, 7)) < 0.8).astype(np.float32)
    hidden = rng.standard_normal((3, 7, 16)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jscoring.evidence_weighted_score(lp, mask, hidden=hidden)),
        tscoring.evidence_weighted_score(t(lp), t(mask),
                                         hidden=t(hidden)).numpy(), **TOL)
    valid = mask[:, 0] > 0.5
    np.testing.assert_allclose(
        np.asarray(jscoring.normalized_success(lp[:, 0], valid)),
        tscoring.normalized_success(t(lp[:, 0]), t(valid)).numpy(), **TOL)


def _round_inputs(rng, N, R, d, V, base_embs):
    # candidates near one of a few directions, so some join clusters
    pick = rng.integers(0, len(base_embs), (N, R))
    embs = base_embs[pick] + 0.05 * rng.standard_normal((N, R, d))
    counts = rng.poisson(0.3, (N, R, V)).astype(np.float32)
    valid = rng.random((N, R)) < 0.85
    return dict(scores=rng.standard_normal((N, R)).astype(np.float32) - 2,
                embs=embs.astype(np.float32), token_counts=counts,
                lengths=rng.integers(1, 9, (N, R)).astype(np.int32),
                valid=valid,
                uids=rng.integers(0, 1000, (N, R)).astype(np.int32))


def _check_state(js, ts):
    for name, jv in js._asdict().items():
        tv = getattr(ts, name)
        if name == "table":
            for f, jf in jv._asdict().items():
                np.testing.assert_allclose(np.asarray(jf),
                                           getattr(tv, f).numpy(), **TOL)
            continue
        jv = np.asarray(jv)
        if jv.dtype.kind in "biu":
            np.testing.assert_array_equal(jv, tv.numpy(), err_msg=name)
        else:
            np.testing.assert_allclose(jv, tv.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("max_clusters", [3, 16])
def test_round_update_assign_field_by_field(max_clusters):
    """Four rounds for three requests; the small table fills up (joins
    the nearest cluster regardless), the large one opens clusters."""
    rng = np.random.default_rng(max_clusters)
    N, R, d, V = 3, 4, 12, 33
    kw = dict(max_clusters=max_clusters, max_rounds=3, min_samples=2)
    jcfg, tcfg = JCAMD(**kw), CAMDConfig(**kw)
    base = rng.standard_normal((4, d))
    js = jax.tree.map(lambda *xs: jnp.stack(xs),
                      *[jctrl.init_state(jcfg, d, V) for _ in range(N)])
    ts = tctrl.init_state(tcfg, N, d, V)
    fn = jax.jit(jctrl.batched_round_update_assign(jcfg))
    for _ in range(4):
        inp = _round_inputs(rng, N, R, d, V, base)
        js, jbias, jcl = fn(js, jctrl.RoundInputs(
            **{k: jnp.asarray(v) for k, v in inp.items()}))
        ts, tbias, tcl = tctrl.round_update_assign(
            tcfg, ts, tctrl.RoundInputs(**{k: t(v) for k, v in inp.items()}))
        np.testing.assert_array_equal(np.asarray(jcl), tcl.numpy())
        np.testing.assert_allclose(np.asarray(jbias), tbias.numpy(), **TOL)
        _check_state(js, ts)
    assert int(ts.table.n_clusters.max()) >= 2


def test_state_stack_and_select_roundtrip():
    cfg = CAMDConfig(max_clusters=4)
    states = [tctrl.init_state(cfg, 1, 3, 5) for _ in range(3)]
    stacked = tctrl.stack_states(states)
    assert stacked.hist.shape == (3, 4, 5)
    one = tctrl.select_state(stacked, 1)
    assert one.table.centroids.shape == (1, 4, 3)
    for a, b in zip(jax.tree.leaves(one), jax.tree.leaves(states[1])):
        assert torch.equal(a, b)
