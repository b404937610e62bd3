"""Evidence-weighted candidate scoring (paper §4.2.1, Eq. 7, 10-12),
following ``repro/core/scoring.py``. The cross-modal alignment term
(Eq. 8-9) needs visual evidence and its kernel, which belong to the
multimodal slice of the port.
"""
from __future__ import annotations

import torch


def _unit(x, eps=1e-8):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def generation_confidence(token_logprobs, mask):
    """Eq. 7: length-normalized sequence log-likelihood over (..., L)."""
    m = mask.float()
    return (token_logprobs * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)


def reasoning_coherence(hidden, mask):
    """Eq. 10-11: mean cosine of consecutive hidden states (..., L, d)."""
    h = _unit(hidden.float())
    sims = (h[..., :-1, :] * h[..., 1:, :]).sum(-1)
    m = (mask[..., :-1] * mask[..., 1:]).float()
    return (sims * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)


def evidence_weighted_score(token_logprobs, mask, *, hidden=None,
                            lambda_c: float = 0.7):
    """Eq. 12 for text-only candidates: S = S_gen + λ_c S_coh."""
    s = generation_confidence(token_logprobs, mask)
    if hidden is not None:
        s = s + lambda_c * reasoning_coherence(hidden, mask)
    return s


def normalized_success(scores, valid):
    """s̃_i = softmax of the scores over valid candidates."""
    masked = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    return torch.softmax(masked, dim=-1)
