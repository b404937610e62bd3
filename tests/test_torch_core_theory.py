"""The rest of the port's CAMD core against the JAX package's, on the CPU:
the §3.2 stop rules (``core/posterior.py``), ``round_update`` and
``score_candidates`` (``core/controller.py``) and the §4.1 theory
(``core/theory.py``).

Same numpy inputs from a seed on both sides. Tolerances (fp32): the stop
rules' values and the theory's deterministic functions rtol 1e-6 / atol
1e-7 (the same fp32 operations; only erf's and pow's implementations
differ), their decisions equal, but for the expected improvement
std (z Φ(z) + φ(z)), held within rtol 1e-3 / atol 1e-6: below z = -2
its two terms nearly cancel, and Φ = (1 + erf) / 2 keeps only the ulps of
erf near -1 (6e-8 each), so the two erfs' last bits move the value by up
to |z| std 6e-8 (6e-4 of a value of 3.9e-5; -2e-7 against 3e-22 at
z = -9.7); ``round_update``'s state and bias as
``tests/test_torch_rescore.py`` holds ``camd_wrap``'s (p_star within
1e-6, bias rtol 2e-4 / atol 1e-4: the log of a mixture whose (1 - sum of
pi_bar) / V term is a rounding residue), counters and decisions equal;
``score_candidates`` rtol/atol 1e-5 on both impls (the cuda impl's
plain K4 on CPU tensors sums in another order). The fits run in float64
on both sides and agree within 1e-9.

The samplers draw from a ``torch.Generator``, not a JAX key, so their
draws are held by distribution: Theorem 4.2's checks of
``tests/test_theory.py`` on the port's draws, and a two-sample
Kolmogorov-Smirnov statistic D between the port's and the reference's
draws of each sampler below ``KS_BOUND``, the critical value of the
two-sided test at level 1e-3 for two samples of ``KS_N`` (D <
sqrt(-ln(5e-4) / 2) * sqrt(2 / KS_N) = 0.0087): two samples of one
distribution exceed it once in a thousand seeds.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CAMDConfig as JCAMD
from repro.core import controller as jctrl
from repro.core import posterior as jpost
from repro.core import theory as jtheory
from repro_torch import config as tconfig
from repro_torch.core import controller as ctrl
from repro_torch.core import posterior, theory
from torch_ranks import _one_torch_thread  # noqa: F401

EXACT = dict(rtol=1e-6, atol=1e-7)
TOL = dict(rtol=1e-5, atol=1e-5)
BIAS_TOL = dict(rtol=2e-4, atol=1e-4)
EI_TOL = dict(rtol=1e-3, atol=1e-6)
KS_N = 100_000
KS_BOUND = math.sqrt(-math.log(1e-3 / 2) / 2) * math.sqrt(2 / KS_N)


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, tol=EXACT):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b.detach().float()), **tol)


def cpu(gen_seed):
    return torch.Generator(device="cpu").manual_seed(gen_seed)


# ---------------------------------------------------------------------------
# §3.2 stop rules
# ---------------------------------------------------------------------------

# the cases of tests/test_camd_core.py:219-245, as 0-dim inputs
THRESHOLD_CASES = [((0.95, 0.9, 0), True, 0), ((0.5, 0.5, 2), True, 3)]
BETA_CASES = [((19.0, 20.0), True), ((1.0, 20.0), False)]
EI_CASES = [((10.0, 0.0, 0.01, 100.0, 1e-3), True),
            ((0.0, 1.0, 1.0, 1.0, 1e-5), False)]


def test_stop_rules_reference_cases():
    for (best, prev, n), stop, rounds in THRESHOLD_CASES:
        got = posterior.threshold_stop(
            torch.tensor(best), torch.tensor(prev),
            torch.tensor(n, dtype=torch.int32), tau=0.9, patience=3)
        assert bool(got[0]) == stop and int(got[1]) == rounds
    for (s, n), stop in BETA_CASES:
        got = posterior.beta_bernoulli_stop(torch.tensor(s), torch.tensor(n),
                                            delta=0.1)
        assert bool(got[0]) == stop
    for (best, mean, std, toks, cost), stop in EI_CASES:
        got = posterior.expected_improvement_stop(
            torch.tensor(best), torch.tensor(mean), torch.tensor(std),
            torch.tensor(toks), cost_per_token=cost)
        assert bool(got[0]) == stop


@pytest.mark.parametrize("shape", [(7,), (3, 5)])
def test_stop_rules_match_on_a_grid(shape):
    """Each rule over a seeded batch of inputs of ``shape``, with ties and
    boundary values among them: the decisions equal, the values within
    fp32 rounding."""
    rng = np.random.default_rng(sum(shape))
    f32 = np.float32

    def draw(lo, hi):
        return rng.uniform(lo, hi, shape).astype(f32)

    best, prev = draw(0.0, 1.0), draw(0.0, 1.0)
    flat = prev.reshape(-1)
    flat[::3] = best.reshape(-1)[::3]          # no improvement: a tie
    best.reshape(-1)[1::4] = 0.9               # the score at tau
    n = rng.integers(0, 4, shape).astype(np.int32)
    for kw in (dict(tau=0.9, patience=3), dict(tau=0.5, patience=1)):
        js, jr = jpost.threshold_stop(best, prev, n, **kw)
        ts, tr = posterior.threshold_stop(t(best), t(prev), t(n), **kw)
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())

    trials = rng.integers(0, 40, shape).astype(f32)
    succ = np.floor(trials * draw(0.0, 1.0)).astype(f32)
    for kw in (dict(delta=0.1), dict(delta=0.3, prior_a=2.0, prior_b=0.5)):
        js, jm = jpost.beta_bernoulli_stop(succ, trials, **kw)
        ts, tm = posterior.beta_bernoulli_stop(t(succ), t(trials), **kw)
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
        close(jm, tm)

    mean, std = draw(-2.0, 2.0), draw(0.0, 1.5)
    std.reshape(-1)[::5] = 0.0                 # clamped at 1e-6
    toks = rng.integers(1, 200, shape).astype(f32)
    for cost in (1e-3, 1e-5):
        js, je = jpost.expected_improvement_stop(best, mean, std, toks,
                                                 cost_per_token=cost)
        ts, te = posterior.expected_improvement_stop(
            t(best), t(mean), t(std), t(toks), cost_per_token=cost)
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
        close(je, te, EI_TOL)


# ---------------------------------------------------------------------------
# round_update, score_candidates
# ---------------------------------------------------------------------------

CAMD = dict(max_clusters=4, min_samples=3, delta=0.3, max_rounds=3,
            cluster_threshold=0.9)
N, R, D, V = 3, 4, 16, 32


def round_inputs(rng, rnd):
    """N requests' rounds of R candidates: embeddings near two of three
    centres (so they cluster), token counts, one invalid row."""
    centres = rng.standard_normal((3, D)).astype(np.float32)
    pick = rng.integers(0, 2, (N, R))
    embs = centres[pick] + 0.1 * rng.standard_normal((N, R, D)).astype(
        np.float32)
    valid = np.ones((N, R), bool)
    valid[2, R - 1] = False
    return dict(
        scores=rng.standard_normal((N, R)).astype(np.float32),
        embs=embs.astype(np.float32),
        token_counts=rng.integers(0, 3, (N, R, V)).astype(np.float32),
        lengths=rng.integers(1, 9, (N, R)).astype(np.int32),
        valid=valid,
        uids=(np.arange(N * R, dtype=np.int32).reshape(N, R) + 100 * rnd))


def test_round_update_matches_over_two_rounds():
    """The port's batched ``round_update`` over N requests against the
    reference's ``round_update`` of each request, two rounds on the same
    inputs: the bias and every state field."""
    jc, tc = JCAMD(**CAMD), tconfig.CAMDConfig(**CAMD)
    jstates = [jctrl.init_state(jc, D, V) for _ in range(N)]
    tstate = ctrl.init_state(tc, N, D, V, device="cpu")
    rng = np.random.default_rng(0)
    for rnd in range(2):
        inp = round_inputs(rng, rnd)
        tstate, tbias = ctrl.round_update(
            tc, tstate, ctrl.RoundInputs(**{k: t(v) for k, v in
                                            inp.items()}))
        for i in range(N):
            jstates[i], jbias = jctrl.round_update(
                jc, jstates[i], jctrl.RoundInputs(
                    **{k: jnp.asarray(v[i]) for k, v in inp.items()}))
            js = jstates[i]
            close(jbias, tbias[i], BIAS_TOL)
            for name in ("k_t", "rounds", "stopped", "best_uid",
                         "best_cluster", "tokens_spent"):
                assert int(getattr(tstate, name)[i]) == \
                    int(getattr(js, name)), (rnd, i, name)
            assert int(tstate.table.n_clusters[i]) == \
                int(js.table.n_clusters)
            close(js.p_star, tstate.p_star[i], dict(rtol=0, atol=1e-6))
            for name in ("best_score", "alpha", "hist"):
                close(getattr(js, name), getattr(tstate, name)[i], TOL)
            for name in ("centroids", "sizes", "score_lse"):
                close(getattr(js.table, name),
                      getattr(tstate.table, name)[i], TOL)
    assert bool(tstate.stopped.any()) and int(tstate.k_t.sum()) > 0


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_score_candidates_matches(impl):
    """Eq. 12 under the config's λ weights, every term present, against
    the reference's ``xla`` impl; and with no evidence, S_gen + λ_c
    S_coh."""
    rng = np.random.default_rng(1)
    B, L, Nv, Nt = 3, 6, 5, 4
    lp = -rng.random((B, L)).astype(np.float32) * 3
    mask = np.ones((B, L), np.float32)
    mask[1, 4:] = 0
    feats = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("hidden", (B, L, D)), ("token_embs", (B, L, D)),
        ("visual_feats", (B, Nv, D)), ("text_feats", (B, Nt, D)))}
    camd = dict(lambda_g=0.6, lambda_c=0.3)
    jc, tc = JCAMD(**camd), tconfig.CAMDConfig(**camd)
    for keys in (tuple(feats), ("hidden",)):
        exp = jctrl.score_candidates(jc, lp, mask, **{
            k: jnp.asarray(feats[k]) for k in keys})
        got = ctrl.score_candidates(tc, t(lp), t(mask), impl=impl, **{
            k: t(feats[k]) for k in keys})
        close(exp, got, TOL)


# ---------------------------------------------------------------------------
# §4.1 theory
# ---------------------------------------------------------------------------

def test_theory_functions_match():
    """coverage, residual_risk, n_delta, heavy_tail_rate, the two fits and
    k_star on the same arrays."""
    rng = np.random.default_rng(2)
    s = rng.random(5000).astype(np.float32)
    s[:3] = (0.0, 1.0, 1e-13)                  # n_delta clamps these
    Ks = np.array([1, 2, 4, 8, 16, 32, 64], np.float32)
    for fn in ("coverage", "residual_risk"):
        close(getattr(jtheory, fn)(jnp.asarray(Ks), jnp.asarray(s)),
              getattr(theory, fn)(t(Ks), t(s)))
    for delta in (0.05, 0.2):
        close(jtheory.n_delta(jnp.asarray(s), delta),
              theory.n_delta(t(s), delta))
    for alpha, kappa in ((0.5, 1.0), (0.7, 0.7)):
        close(jtheory.heavy_tail_rate(Ks, alpha, kappa),
              theory.heavy_tail_rate(Ks, alpha, kappa))
    deltas = np.asarray(jtheory.residual_risk(jnp.asarray(Ks),
                                              jnp.asarray(s)))
    for fit in ("fit_power_law", "fit_exponential"):
        exp = getattr(jtheory, fit)(Ks, deltas)
        for arg in (deltas, t(deltas)):
            got = getattr(theory, fit)(Ks, arg)
            np.testing.assert_allclose(got, exp, rtol=1e-9, atol=0)
    for args, kw in (((0.1, 0.0, "heavy"), dict(alpha=0.5)),
                     ((0.01, 0.0, "heavy"), dict(alpha=0.7, kappa=2.0)),
                     ((0.05, 0.01, "stretched"), dict(theta=0.5)),
                     ((0.01, 0.0, "light"), {}),
                     ((0.05, 0.1, "heavy"), {})):
        assert theory.k_star(*args, **kw) == jtheory.k_star(*args, **kw)
    with pytest.raises(ValueError):
        theory.k_star(0.1, 0.0, "flat")


def test_coverage_monotone_and_complement():
    s = theory.sample_heavy_tail(cpu(0), 20000, alpha=0.5, device="cpu")
    Ks = torch.tensor([1, 2, 4, 8, 16, 32, 64])
    cov, res = theory.coverage(Ks, s), theory.residual_risk(Ks, s)
    np.testing.assert_allclose((cov + res).numpy(), 1.0, rtol=1e-6)
    assert bool((cov.diff() > 0).all())


def test_theorem_42_heavy_tail_power_law():
    """As ``tests/test_theory.py``: the fitted exponent of Δ(K) recovers α,
    and Δ(K) / (α Γ(α) K^-α) has a median near 1."""
    for alpha in (0.4, 0.7):
        s = theory.sample_heavy_tail(cpu(1), 400000, alpha, device="cpu")
        Ks = np.array([4, 8, 16, 32, 64, 128, 256])
        deltas = theory.residual_risk(Ks, s).numpy()
        fitted, _ = theory.fit_power_law(Ks, deltas)
        assert abs(fitted - alpha) < 0.12, (alpha, fitted)
        pred = theory.heavy_tail_rate(Ks, alpha, kappa=alpha).numpy()
        assert 0.8 < np.median(deltas / pred) < 1.25


def test_theorem_42_light_tail_exponential():
    s = theory.sample_light_tail(cpu(2), 200000, lo=0.2, device="cpu")
    Ks = np.array([1, 2, 4, 8, 16, 24, 32])
    deltas = theory.residual_risk(Ks, s).numpy()
    c, b = theory.fit_exponential(Ks, deltas)
    assert c > 0.15, "light tail must decay exponentially"
    assert np.abs((b - c * Ks) - np.log(deltas)).max() < 0.7


def test_theorem_42_ordering():
    """At equal K, residual risk: heavy > stretched > light."""
    n = 200000
    K = torch.tensor([64])
    dh = float(theory.residual_risk(K, theory.sample_heavy_tail(
        cpu(3), n, 0.5, device="cpu"))[0])
    de = float(theory.residual_risk(K, theory.sample_stretched_exp(
        cpu(4), n, device="cpu"))[0])
    dl = float(theory.residual_risk(K, theory.sample_light_tail(
        cpu(5), n, device="cpu"))[0])
    assert dh > de > dl


def test_k_star_scaling():
    heavy = [theory.k_star(e, 0.0, "heavy", alpha=0.5) for e in (0.1, 0.01)]
    light = [theory.k_star(e, 0.0, "light") for e in (0.1, 0.01)]
    assert heavy[1] / heavy[0] > 50
    assert light[1] / light[0] < 3
    assert theory.k_star(0.05, 0.1, "heavy") == float("inf")


def ks_statistic(a, b):
    """Two-sample Kolmogorov-Smirnov D = sup |F_a - F_b|."""
    a, b = np.sort(a), np.sort(b)
    x = np.concatenate([a, b])
    fa = np.searchsorted(a, x, side="right") / a.size
    fb = np.searchsorted(b, x, side="right") / b.size
    return float(np.abs(fa - fb).max())


@pytest.mark.parametrize("sampler,kw", [
    ("sample_heavy_tail", dict(alpha=0.5)),
    ("sample_heavy_tail", dict(alpha=0.2)),
    ("sample_stretched_exp", dict(c=1.0, theta=1.0)),
    ("sample_stretched_exp", dict(c=2.0, theta=0.5)),
    ("sample_light_tail", dict(lo=0.2, hi=0.9)),
])
def test_samplers_match_reference_in_distribution(sampler, kw):
    """The port's draws against the reference's: KS statistic under
    ``KS_BOUND``; every draw in [0, 1] (a heavy tail's U^(1/α) may
    underflow to 0 in fp32, as the reference's), fp32, on the asked
    device."""
    ours = getattr(theory, sampler)(cpu(7), KS_N, device="cpu", **kw)
    ref = getattr(jtheory, sampler)(jax.random.PRNGKey(7), KS_N, **kw)
    assert ours.dtype == torch.float32 and ours.device.type == "cpu"
    assert ours.shape == (KS_N,)
    assert bool(((ours >= 0) & (ours <= 1)).all())
    d = ks_statistic(ours.numpy(), np.asarray(ref))
    assert d < KS_BOUND, (d, KS_BOUND)


def test_samplers_default_to_the_card(monkeypatch):
    """With no ``device`` the samplers draw on the CUDA device: without
    one they raise, as the port's other entry points do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        theory.sample_light_tail(cpu(0), 4)
