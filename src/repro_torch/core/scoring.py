"""Evidence-weighted candidate scoring (paper §4.2.1, Eq. 7-12),
following ``repro/core/scoring.py``. The cross-modal alignment term
(Eq. 8-9) has a hand-written kernel (``kernels.ops.xmodal_score``),
selected with ``impl="cuda"``; the plain path here is the reference's.
"""
from __future__ import annotations

import torch


def _unit(x, eps=1e-8):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def generation_confidence(token_logprobs, mask):
    """Eq. 7: length-normalized sequence log-likelihood over (..., L)."""
    m = mask.float()
    return (token_logprobs * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)


def cross_modal_consistency(token_embs, mask, visual_feats, text_feats, *,
                            impl: str = "torch"):
    """Eq. 8-9: S_align over (..., L, d) token embeddings f(y_t), with
    visual evidence (Nv, d) or (..., Nv, d) and prompt-text evidence
    (Nt, d) or (..., Nt, d):

      S_align = mean_t 1/2 [mean_j cos(v_j, f(y_t)) + mean_r max_j cos(t_r, v_j)]

    ``impl="cuda"`` runs the K4 kernels (batched (B, ., d) inputs)."""
    if impl == "cuda":
        from repro_torch.kernels import ops
        return ops.xmodal_score(token_embs, mask.float(), visual_feats,
                                text_feats)
    tok = _unit(token_embs.float())
    vis = _unit(visual_feats.float())
    txt = _unit(text_feats.float())
    m = mask.float()
    term1 = torch.einsum("...ld,...nd->...ln", tok, vis).mean(-1)
    term1 = (term1 * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)
    term2 = torch.einsum("...rd,...nd->...rn", txt, vis).amax(-1).mean(-1)
    return 0.5 * (term1 + term2)


def reasoning_coherence(hidden, mask):
    """Eq. 10-11: mean cosine of consecutive hidden states (..., L, d)."""
    h = _unit(hidden.float())
    sims = (h[..., :-1, :] * h[..., 1:, :]).sum(-1)
    m = (mask[..., :-1] * mask[..., 1:]).float()
    return (sims * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)


def evidence_weighted_score(token_logprobs, mask, *, hidden=None,
                            token_embs=None, visual_feats=None,
                            text_feats=None, lambda_g: float = 0.9,
                            lambda_c: float = 0.7, impl: str = "torch"):
    """Eq. 12: S = S_gen + λ_g S_align + λ_c S_coh. Terms whose inputs are
    missing (no visual evidence for a text-only model) add nothing."""
    s = generation_confidence(token_logprobs, mask)
    if visual_feats is not None and token_embs is not None:
        tf = text_feats if text_feats is not None else token_embs
        s = s + lambda_g * cross_modal_consistency(
            token_embs, mask, visual_feats, tf, impl=impl)
    if hidden is not None:
        s = s + lambda_c * reasoning_coherence(hidden, mask)
    return s


def normalized_success(scores, valid):
    """s̃_i = softmax of the scores over valid candidates."""
    masked = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    return torch.softmax(masked, dim=-1)
