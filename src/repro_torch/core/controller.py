"""CAMD round controller (``repro/core/controller.py``), as batched tensor
ops: every ``CAMDState`` field carries a leading request axis N, and one
call folds the completed rounds of N requests. So ``init_state(cfg, n,
...)`` is the reference's ``batched_init``, ``round_update_assign`` its
``batched_round_update_assign`` and ``round_update`` its
``batched_round_update`` (the reference vmaps its one-request functions
over requests, ``controller.py:118-135``); a single request is N = 1.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from repro_torch.config import CAMDConfig
from repro_torch.core import clustering, posterior, scoring


class CAMDState(NamedTuple):
    table: clustering.ClusterTable
    alpha: torch.Tensor          # (N, M) Dirichlet params
    hist: torch.Tensor           # (N, M, V) cluster token histograms
    k_t: torch.Tensor            # (N,) int32 cumulative samples
    rounds: torch.Tensor         # (N,) int32
    stopped: torch.Tensor        # (N,) bool
    p_star: torch.Tensor         # (N,) latest coverage estimate
    best_score: torch.Tensor     # (N,)
    best_uid: torch.Tensor       # (N,) int32 engine-side candidate id
    best_cluster: torch.Tensor   # (N,) int32
    tokens_spent: torch.Tensor   # (N,) int32


class RoundInputs(NamedTuple):
    """One round of R candidates per request (leading axis N)."""
    scores: torch.Tensor         # (N, R) evidence-weighted scores
    embs: torch.Tensor           # (N, R, d) mean-pooled embeddings
    token_counts: torch.Tensor   # (N, R, V)
    lengths: torch.Tensor        # (N, R) generated lengths
    valid: torch.Tensor          # (N, R) bool
    uids: torch.Tensor           # (N, R) int32


def init_state(cfg: CAMDConfig, n: int, emb_dim: int, vocab: int,
               device=None) -> CAMDState:
    M = cfg.max_clusters

    def full(val, dtype):
        return torch.full((n,), val, dtype=dtype, device=device)

    return CAMDState(
        table=clustering.make_table(n, M, emb_dim, device),
        alpha=torch.full((n, M), cfg.dirichlet_prior, device=device),
        hist=torch.zeros((n, M, vocab), device=device),
        k_t=full(0, torch.int32), rounds=full(0, torch.int32),
        stopped=full(False, torch.bool), p_star=full(0.0, torch.float32),
        best_score=full(-torch.inf, torch.float32),
        best_uid=full(-1, torch.int32), best_cluster=full(-1, torch.int32),
        tokens_spent=full(0, torch.int32))


def stack_states(states: List[CAMDState]) -> CAMDState:
    """Concatenate per-request states along the request axis."""
    def cat(*xs):
        if isinstance(xs[0], clustering.ClusterTable):
            return clustering.ClusterTable(*map(cat, *xs))
        return torch.cat(xs, dim=0)
    return CAMDState(*map(cat, *states))


def select_state(state: CAMDState, i: int) -> CAMDState:
    """Request ``i`` of a batched state, keeping the axis (size 1)."""
    def take(x):
        if isinstance(x, clustering.ClusterTable):
            return clustering.ClusterTable(*map(take, x))
        return x[i:i + 1]
    return CAMDState(*map(take, state))


def round_update(cfg: CAMDConfig, state: CAMDState, inp: RoundInputs
                 ) -> Tuple[CAMDState, torch.Tensor]:
    """Fold one round of candidates into each request's state. Returns
    (state, the Eq. 16 guidance bias (N, V) for the next round's logits,
    zeros once stopped): ``round_update_assign`` without the assignment
    (``controller.py:63-72``)."""
    state, bias, _ = round_update_assign(cfg, state, inp)
    return state, bias


def round_update_assign(cfg: CAMDConfig, state: CAMDState, inp: RoundInputs
                        ) -> Tuple[CAMDState, torch.Tensor, torch.Tensor]:
    """Fold one round of candidates into each request's state: score ->
    cluster -> coverage test -> Dirichlet update -> mixture guidance.
    Returns (state, guidance bias (N, V) — zeros once stopped, cluster
    assignment (N, R) int32, -1 for invalid rows)."""
    valid = inp.valid & ~state.stopped[:, None]
    scores = inp.scores * cfg.score_scale
    table, cluster_idx = clustering.assign_batch(
        state.table, inp.embs, scores, valid, cfg.cluster_threshold)

    M = state.alpha.shape[1]
    one = (torch.arange(M, device=valid.device)[None, None, :] ==
           torch.clamp(cluster_idx.long(), min=0)[:, :, None]).float() * \
        valid.float()[:, :, None]                               # (N, R, M)
    hist = state.hist + torch.einsum("nrm,nrv->nmv", one, inp.token_counts)

    k_t = state.k_t + valid.sum(dim=1).to(torch.int32)
    tokens = state.tokens_spent + torch.where(
        valid, inp.lengths, torch.zeros_like(inp.lengths)).sum(dim=1).to(
            torch.int32)

    masked = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    r_best = torch.argmax(masked, dim=1, keepdim=True)
    cand = masked.gather(1, r_best)[:, 0]
    improved = cand > state.best_score
    best_score = torch.where(improved, cand, state.best_score)
    best_uid = torch.where(improved, inp.uids.gather(1, r_best)[:, 0],
                           state.best_uid)
    best_cluster = torch.where(improved, cluster_idx.gather(1, r_best)[:, 0],
                               state.best_cluster)

    stop, p_star = posterior.coverage_reached(
        table, k_t, delta=cfg.delta, min_samples=cfg.min_samples)
    rounds = state.rounds + (~state.stopped).to(torch.int32)
    stopped = state.stopped | stop | (rounds >= cfg.max_rounds)

    alpha, pi_bar = posterior.dirichlet_update(state.alpha, table)
    bias = posterior.mixture_logit_bias(pi_bar, hist,
                                        strength=cfg.guidance_strength)
    bias = torch.where(stopped[:, None], torch.zeros_like(bias), bias)

    new_state = CAMDState(
        table=table, alpha=alpha, hist=hist, k_t=k_t, rounds=rounds,
        stopped=stopped, p_star=p_star, best_score=best_score,
        best_uid=best_uid, best_cluster=best_cluster, tokens_spent=tokens)
    return new_state, bias, cluster_idx


def score_candidates(cfg: CAMDConfig, token_logprobs, mask, *, hidden=None,
                     token_embs=None, visual_feats=None, text_feats=None,
                     impl: str = "torch"):
    """Eq. 12 with this config's λ weights (``controller.py:138-145``);
    ``impl="cuda"`` runs S_align through the K4 kernels."""
    return scoring.evidence_weighted_score(
        token_logprobs, mask, hidden=hidden, token_embs=token_embs,
        visual_feats=visual_feats, text_feats=text_feats,
        lambda_g=cfg.lambda_g, lambda_c=cfg.lambda_c, impl=impl)
