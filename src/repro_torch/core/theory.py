"""Numerics of the paper's theoretical framework (§4.1), following
``repro/core/theory.py``.

Coverage C(K), residual risk Δ(K), the δ-coverage sample size N_δ
(Def. 4.1), samplers of the difficulty distributions of Theorem 4.2's
three tail classes, tail-exponent fits to an empirical Δ(K) decay, and
the K*(ε) budget rule of Eq. 6. The samplers take a ``torch.Generator``
where the reference takes a JAX key, and draw on ``device`` (the card
unless the caller asks for the CPU); the generator must live on that
device. The fits run in float64 numpy, as the reference's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device

# ---------------------------------------------------------------------------
# basic coverage quantities (Eq. 2-4)
# ---------------------------------------------------------------------------


def _budgets(K, s):
    return torch.as_tensor(K, dtype=torch.float32, device=s.device)


def coverage(K, s):
    """C(K) = E_s[1 - (1-s)^K] over the samples s (last axis) — Eq. 2;
    one value for each budget in K."""
    K = _budgets(K, s)
    return (1.0 - torch.pow(1.0 - s, K[..., None])).mean(dim=-1)


def residual_risk(K, s):
    """Δ(K) = E_s[(1-s)^K] — Eq. 3."""
    K = _budgets(K, s)
    return torch.pow(1.0 - s, K[..., None]).mean(dim=-1)


def n_delta(s, delta: float):
    """Def. 4.1: the fewest trials that cover an instance of success
    probability s with probability 1 - δ."""
    s = torch.clamp(s, 1e-12, 1.0 - 1e-12)
    log_delta = torch.log(torch.tensor(delta, dtype=s.dtype,
                                       device=s.device))
    return torch.ceil(log_delta / torch.log1p(-s))


# ---------------------------------------------------------------------------
# difficulty distributions G(s) of Theorem 4.2's tail classes
# ---------------------------------------------------------------------------


def _uniform(generator, n: int, device, minval: float = 0.0,
             maxval: float = 1.0):
    """U[minval, maxval) in fp32, as ``jax.random.uniform`` maps its bits."""
    u = torch.rand(n, generator=generator, device=resolve_device(device))
    return torch.clamp_min(u * (maxval - minval) + minval, minval)


def sample_heavy_tail(generator, n: int, alpha: float = 0.5, *,
                      device=None):
    """g(s) = α s^(α-1) on (0, 1): a heavy (polynomial) lower tail. The
    CDF is G(s) = s^α, so s = U^(1/α)."""
    return torch.pow(_uniform(generator, n, device, minval=1e-12),
                     1.0 / alpha)


def sample_stretched_exp(generator, n: int, c: float = 1.0,
                         theta: float = 1.0, *, device=None):
    """log Pr(s <= ε) ~ -c ε^-θ: a stretched-exponential lower tail,
    drawn by inverting G(s) = exp(-c s^-θ) on (0, 1]."""
    z = np.exp(-c)  # G(1)
    u = _uniform(generator, n, device, minval=1e-30) * z
    return torch.pow(-torch.log(u) / c, -1.0 / theta).clamp(0.0, 1.0)


def sample_light_tail(generator, n: int, lo: float = 0.2, hi: float = 0.9,
                      *, device=None):
    """Truncated support, G([0, lo]) = 0: the light (truncated) tail."""
    return _uniform(generator, n, device, minval=lo, maxval=hi)


# ---------------------------------------------------------------------------
# Theorem 4.2 asymptotics and their estimation
# ---------------------------------------------------------------------------


def heavy_tail_rate(K, alpha: float, kappa: float = 1.0):
    """Δ(K) ~ κ Γ(α) K^-α (slowly varying ℓ ≡ 1)."""
    K = torch.as_tensor(K, dtype=torch.float32)
    return kappa * math.gamma(alpha) * torch.pow(K, -alpha)


def _float64(x):
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def fit_power_law(Ks, deltas):
    """Least-squares fit of log Δ = -α log K + c. Returns (alpha, c)."""
    x = np.log(_float64(Ks))
    y = np.log(np.maximum(_float64(deltas), 1e-300))
    A = np.stack([x, np.ones_like(x)], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    return -coef[0], coef[1]


def fit_exponential(Ks, deltas):
    """Least-squares fit of log Δ = -c K + b. Returns (c, b)."""
    x = _float64(Ks)
    y = np.log(np.maximum(_float64(deltas), 1e-300))
    A = np.stack([x, np.ones_like(x)], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    return -coef[0], coef[1]


def k_star(epsilon: float, r_irr: float, tail: str, *, alpha: float = 0.5,
           kappa: float = 1.0, theta: float = 1.0) -> float:
    """Eq. 6: the least sampling budget that brings the total risk under
    ε, given the irreducible risk ``r_irr``; inf when ε <= r_irr."""
    margin = epsilon - r_irr
    if margin <= 0:
        return float("inf")
    if tail == "heavy":
        return (kappa * math.gamma(alpha) / margin) ** (1.0 / alpha)
    if tail == "stretched":
        return math.log(1.0 / margin) ** ((theta + 1.0) / theta)
    if tail == "light":
        return math.log(1.0 / margin)
    raise ValueError(tail)
