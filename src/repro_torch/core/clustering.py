"""Online semantic clustering of candidate answers (paper Eq. 13), batched.

Follows ``repro/core/clustering.py`` with a leading request axis N on every
table field (the reference vmaps over requests instead): a fixed-capacity
table of M running-mean centroids per request; a candidate joins its
nearest cluster at cosine >= threshold, opens a new one otherwise, and
joins the nearest regardless once the table is full.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class ClusterTable(NamedTuple):
    centroids: torch.Tensor   # (N, M, d) running-mean embeddings
    sizes: torch.Tensor       # (N, M) float32 member counts
    score_lse: torch.Tensor   # (N, M) logsumexp of member scores
    n_clusters: torch.Tensor  # (N,) int32


def make_table(n: int, max_clusters: int, emb_dim: int,
               device=None) -> ClusterTable:
    return ClusterTable(
        centroids=torch.zeros((n, max_clusters, emb_dim), device=device),
        sizes=torch.zeros((n, max_clusters), device=device),
        score_lse=torch.full((n, max_clusters), -torch.inf, device=device),
        n_clusters=torch.zeros((n,), dtype=torch.int32, device=device))


def _unit(x, eps=1e-8):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def assign_one(table: ClusterTable, emb, score, valid, threshold: float
               ) -> Tuple[ClusterTable, torch.Tensor]:
    """Assign one candidate per request. emb: (N, d); score: (N,); valid:
    (N,) bool. Returns (table, cluster index (N,) int32, -1 if invalid)."""
    N, M = table.sizes.shape
    ar = torch.arange(M, device=emb.device)
    n_cl = table.n_clusters.long()
    active = ar[None, :] < n_cl[:, None]
    sims = torch.einsum("nd,nmd->nm", _unit(emb), _unit(table.centroids))
    sims = torch.where(active, sims, torch.full_like(sims, -torch.inf))
    best = torch.argmax(sims, dim=-1)
    best_sim = sims.gather(1, best[:, None])[:, 0]
    join = (best_sim >= threshold) | ((n_cl >= M) & (n_cl > 0))
    idx = torch.clamp(torch.where(join, best, n_cl), max=M - 1)
    one = (ar[None, :] == idx[:, None]).float()             # (N, M)
    vf = valid.float()[:, None]
    new_sizes = table.sizes + one * vf
    hit = (one[:, :, None] > 0) & valid[:, None, None]
    new_cent = torch.where(
        hit,
        (table.centroids * table.sizes[:, :, None] +
         emb[:, None, :] * one[:, :, None]) /
        torch.clamp(new_sizes[:, :, None], min=1.0),
        table.centroids)
    new_lse = torch.where(one > 0,
                          torch.logaddexp(table.score_lse, score[:, None]),
                          table.score_lse)
    new_lse = torch.where(valid[:, None], new_lse, table.score_lse)
    new_n = torch.where(valid & ~join, n_cl + 1, n_cl).clamp(max=M)
    out = ClusterTable(
        centroids=new_cent,
        sizes=torch.where(valid[:, None], new_sizes, table.sizes),
        score_lse=new_lse, n_clusters=new_n.to(torch.int32))
    return out, torch.where(valid, idx, torch.full_like(idx, -1)).to(
        torch.int32)


def assign_batch(table: ClusterTable, embs, scores, valids, threshold: float
                 ) -> Tuple[ClusterTable, torch.Tensor]:
    """Assign a round of R candidates per request in order (a sequential
    loop over R, as the reference's scan). embs: (N, R, d); scores and
    valids: (N, R). Returns (table, (N, R) int32 cluster indices)."""
    idxs = []
    for r in range(embs.shape[1]):
        table, idx = assign_one(table, embs[:, r], scores[:, r],
                                valids[:, r], threshold)
        idxs.append(idx)
    return table, torch.stack(idxs, dim=1)


def posterior_weights(table: ClusterTable):
    """Eq. 14: p̂_k = Σ_{i∈C_k} exp(S_i) / Σ_all exp(S_i), per request."""
    M = table.score_lse.shape[1]
    active = torch.arange(M, device=table.score_lse.device)[None, :] < \
        table.n_clusters.long()[:, None]
    lse = torch.where(active, table.score_lse,
                      torch.full_like(table.score_lse, -torch.inf))
    total = torch.logsumexp(lse, dim=-1, keepdim=True)
    return torch.where(active, torch.exp(lse - total),
                       torch.zeros_like(lse))
