"""Cross-entropy loss with z-loss and MoE auxiliary terms
(``repro/training/loss.py``)."""
from __future__ import annotations

import torch


def cross_entropy(logits, labels, mask=None, z_loss_coef: float = 1e-4):
    """logits: (B, L, V), labels: (B, L). Returns (loss, metrics): the
    masked mean of nll + z_loss_coef * logsumexp^2 over max(sum(mask), 1)
    positions, with the mean nll, the argmax accuracy and the perplexity
    exp(clip(nll, 0, 20))."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    z = z_loss_coef * lse.square()
    m = torch.ones_like(nll) if mask is None else mask.float()
    n = torch.clamp(m.sum(), min=1.0)
    loss = ((nll + z) * m).sum() / n
    hit = (logits.argmax(-1) == labels.long()).float()
    mean_nll = (nll * m).sum() / n
    return loss, {"nll": mean_nll, "accuracy": (hit * m).sum() / n,
                  "perplexity": torch.exp(torch.clamp(mean_nll, 0, 20))}


def total_loss(logits, labels, aux, mask=None, moe_aux_weight: float = 0.01,
               moe_z_weight: float = 1e-3):
    """``cross_entropy`` plus, for an MoE model, ``moe_aux_weight`` times
    the load-balance loss and ``moe_z_weight`` times the router z-loss."""
    loss, metrics = cross_entropy(logits, labels, mask)
    if "moe_lb_loss" in aux:
        loss = loss + moe_aux_weight * aux["moe_lb_loss"] \
            + moe_z_weight * aux["moe_z_loss"]
        metrics["moe_lb_loss"] = aux["moe_lb_loss"]
        metrics["moe_drop_frac"] = aux.get("moe_drop_frac", 0.0)
    metrics["loss"] = loss
    return loss, metrics
