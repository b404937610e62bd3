"""Plug-and-play CAMD rescoring, the paper's §5.1 deployment mode
(``repro/core/rescore.py``).

Candidates may come from any decoder (an external engine, beam search,
another model): one teacher-forced forward over [prompt ++ candidate]
gives every Eq. 7-12 ingredient (token log-probs, hidden states, token
embeddings); the candidates are scored, folded into a CAMD state, and the
coverage stop, best candidate and mixture bias come back. ``impl="cuda"``
runs the forward's attention through the flash kernel (K2), an MoE
model's dispatch and combine through K5, and S_align through K4;
``"torch"`` runs their plain versions. Everything runs under
``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import CAMDConfig
from repro_torch.core import controller as ctrl
from repro_torch.core import scoring


@torch.no_grad()
def teacher_forced_stats(model, prompt, candidates, mask, evidence=None, *,
                         impl: str = "torch"):
    """One forward over [prompt ++ candidate] per candidate.

    prompt: (Lp,) int; candidates: (K, Lc) int (right-padded); mask:
    (K, Lc), 1 = real token; evidence: optional (Ne, De), shared by the
    candidates. Returns (token_logprobs (K, Lc) masked, hidden (K, Lc, d),
    token_embs (K, Lc, d) fp32)."""
    cfg = model.cfg
    K, Lc = candidates.shape
    Lp = prompt.shape[0]
    toks = torch.cat([prompt[None].expand(K, Lp), candidates], dim=1)
    ev = None if evidence is None else \
        evidence[None].expand((K,) + tuple(evidence.shape))
    logits, hidden, _ = model.forward(toks, ev, impl=impl)
    ne = cfg.num_evidence_tokens
    offs = ne if (ne and evidence is not None
                  and not cfg.is_encoder_decoder) else 0
    # logits at position p predict token p+1: candidate token j (absolute
    # position Lp+j) is predicted by logits at offs+Lp+j-1
    pred = logits[:, offs + Lp - 1: offs + Lp + Lc - 1]
    logp = torch.log_softmax(pred.float(), dim=-1)
    token_lp = logp.gather(-1, candidates.long()[..., None])[..., 0]
    cand_hidden = hidden[:, offs + Lp: offs + Lp + Lc]
    token_embs = model.embed.table[candidates.long()].float()
    return token_lp * mask.to(token_lp.dtype), cand_hidden, token_embs


def _masked_mean(h, mask):
    m = mask.float()[..., None]
    return (h.float() * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


@torch.no_grad()
def rescore_candidates(model, cfg: CAMDConfig, prompt, candidates, mask,
                       evidence=None, *, impl: str = "torch"
                       ) -> Dict[str, torch.Tensor]:
    """Eq. 7-12 evidence-weighted scores of externally generated
    candidates: per candidate ``score``, its terms ``s_gen``, ``s_align``
    (zero without evidence), ``s_coh``, and ``hidden_mean`` (K, d). A
    model cut for a rank of a serving mesh is refused."""
    if getattr(model, "world", None) is not None:
        raise NotImplementedError(
            f"{model.cfg.name}: rescoring with a model cut for a rank is "
            "not ported (ROADMAP.md Queue 1 item 5); the serving engine "
            "rescores over ranks")
    token_lp, hidden, token_embs = teacher_forced_stats(
        model, prompt, candidates, mask, evidence, impl=impl)
    s_gen = scoring.generation_confidence(token_lp, mask)
    s_coh = scoring.reasoning_coherence(hidden, mask)
    K = candidates.shape[0]
    if evidence is not None and model.cfg.num_evidence_tokens:
        vis = evidence.float()
        if model.evidence_proj is not None:
            vis = model.project_evidence(vis)
        txt = model.embed.table[prompt.long()].float()
        # the K4 kernels take (K, ., d) rows of their own
        vis = vis[None].expand((K,) + tuple(vis.shape)).contiguous()
        txt = txt[None].expand((K,) + tuple(txt.shape)).contiguous()
        s_align = scoring.cross_modal_consistency(
            token_embs, mask, vis, txt, impl=impl)
    else:
        s_align = torch.zeros_like(s_gen)
    total = s_gen + cfg.lambda_g * s_align + cfg.lambda_c * s_coh
    return {"score": total, "s_gen": s_gen, "s_align": s_align,
            "s_coh": s_coh, "hidden_mean": _masked_mean(hidden, mask)}


@torch.no_grad()
def camd_wrap(model, cfg: CAMDConfig, prompt, candidates, mask,
              evidence=None, *, state: Optional[ctrl.CAMDState] = None,
              uids=None, impl: str = "torch"
              ) -> Tuple[ctrl.CAMDState, Dict[str, Any]]:
    """One CAMD checkpoint over a round of external candidates. ``state``
    is the controller's batched state for one request (``init_state(cfg,
    1, ...)``; a new one when None). Returns (state, decision): ``stop``,
    ``p_star``, ``best_uid``, the Eq. 16 mixture ``bias`` (V,) for the
    next round, ``scores`` and the ``terms`` s_gen, s_align, s_coh."""
    K = candidates.shape[0]
    dev = candidates.device
    if state is None:
        state = ctrl.init_state(cfg, 1, model.cfg.d_model,
                                model.cfg.vocab_size, device=dev)
    if uids is None:
        uids = torch.arange(K, dtype=torch.int32, device=dev)
    res = rescore_candidates(model, cfg, prompt, candidates, mask, evidence,
                             impl=impl)
    m = mask.float()
    counts = torch.zeros((K, model.cfg.vocab_size), device=dev).scatter_add_(
        1, candidates.long(), m)
    inp = ctrl.RoundInputs(
        scores=res["score"][None], embs=res["hidden_mean"][None],
        token_counts=counts[None],
        lengths=m.sum(-1).to(torch.int32)[None],
        valid=(m > 0).any(-1)[None],
        uids=torch.as_tensor(uids, dtype=torch.int32, device=dev)[None])
    state, bias = ctrl.round_update(cfg, state, inp)
    decision = {
        "stop": state.stopped[0], "p_star": state.p_star[0],
        "best_uid": state.best_uid[0], "bias": bias[0],
        "scores": res["score"],
        "terms": {k: res[k] for k in ("s_gen", "s_align", "s_coh")},
    }
    return state, decision
