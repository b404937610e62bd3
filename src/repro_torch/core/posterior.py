"""Posterior coverage estimation and Bayesian adaptive sampling
(paper §4.2.2-§4.2.3, Eq. 14-16), batched over requests, and the §3.2
stopping baselines — follows ``repro/core/posterior.py``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.clustering import ClusterTable, posterior_weights


def coverage_reached(table: ClusterTable, k_t, *, delta: float,
                     min_samples: int):
    """Stop when p̂* = max_k p̂_k >= 1 - δ and at least ``min_samples``
    candidates were drawn. Returns (stop (N,), p_star (N,))."""
    p_star = posterior_weights(table).amax(dim=-1)
    return (p_star >= 1.0 - delta) & (k_t >= min_samples), p_star


def dirichlet_update(alpha, table: ClusterTable):
    """Eq. 15: α' = α + n with soft counts n_k = p̂_k. Returns
    (alpha' (N, M), π̄ = E[π | D_t] (N, M))."""
    M = alpha.shape[1]
    active = torch.arange(M, device=alpha.device)[None, :] < \
        table.n_clusters.long()[:, None]
    new_alpha = alpha + posterior_weights(table)
    masked = torch.where(active, new_alpha, torch.zeros_like(new_alpha))
    pi_bar = masked / torch.clamp(masked.sum(dim=-1, keepdim=True), min=1e-9)
    return new_alpha, pi_bar


def mixture_logit_bias(pi_bar, cluster_hist, *, strength: float = 1.0,
                       eps: float = 1e-6):
    """Eq. 16 as a decoding bias: ``strength * log Σ_k π̄_k q_k(y)`` with q_k
    the smoothed token distribution of cluster k, made zero-mean.
    pi_bar: (N, M); cluster_hist: (N, M, V). Returns (N, V)."""
    V = cluster_hist.shape[-1]
    totals = cluster_hist.sum(dim=-1, keepdim=True)
    q = (cluster_hist + eps) / (totals + eps * V)
    p_mix = torch.einsum("nm,nmv->nv", pi_bar, q)
    p_mix = p_mix + (1.0 - pi_bar.sum(dim=-1, keepdim=True)) / V
    bias = strength * torch.log(p_mix + 1e-20)
    return bias - bias.mean(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# §3.2 adaptive stopping baselines (the motivation experiment's rules),
# elementwise over tensors of any shape (``posterior.py:61-92``)
# ---------------------------------------------------------------------------

def threshold_stop(best_score, prev_best, no_improve_rounds, *, tau: float,
                   patience: int):
    """Rule (i): stop once the best score reaches ``tau``, or after
    ``patience`` rounds without improvement. Returns (stop, rounds), the
    count of rounds without improvement."""
    improved = best_score > prev_best + 1e-9
    rounds = torch.where(improved, torch.zeros_like(no_improve_rounds),
                         no_improve_rounds + 1)
    return (best_score >= tau) | (rounds >= patience), rounds


def beta_bernoulli_stop(successes, trials, *, delta: float,
                        prior_a: float = 1.0, prior_b: float = 1.0):
    """Rule (ii): a Beta(prior_a, prior_b) posterior on a trial's success;
    stop when its mean failure is below δ. Returns (stop, mean_fail)."""
    a = prior_a + successes
    b = prior_b + trials - successes
    mean_fail = b / (a + b)
    return mean_fail < delta, mean_fail


def expected_improvement_stop(best_score, score_mean, score_std,
                              tokens_per_sample, *, cost_per_token: float):
    """Rule (iii): stop when one more sample's expected improvement over
    the best score, under a normal model of the scores, is below its
    token cost. Returns (stop, ei)."""
    z = (score_mean - best_score) / torch.clamp(score_std, min=1e-6)
    phi = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    Phi = 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))
    ei = score_std * (z * Phi + phi)
    return ei < cost_per_token * tokens_per_sample, ei
