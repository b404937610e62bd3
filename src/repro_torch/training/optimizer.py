"""AdamW, learning-rate schedules and global-norm clipping
(``repro/training/optimizer.py``), as functions on a named-parameter dict
{name: tensor} rather than ``torch.optim``: the reference's order of
operations is what the tests hold.

Parameters and the moments ``m``, ``v`` are updated in place, one tensor
at a time, so the update's temporaries stay the size of the largest
parameter (granite-moe-3b-a800m's fp32 weights, gradients and moments
already fill 53 GB of an 80 GB card).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from repro_torch.config import TrainConfig

Tree = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor     # () int32, steps taken
    m: Tree                # first moments, one per parameter
    v: Tree                # second moments


def init_opt_state(params: Tree, dtype=torch.float32) -> OptState:
    """Zero moments of ``dtype`` (bf16 halves their memory; the update
    still computes in fp32). The step counter lives on the parameters'
    device."""
    dev = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=dtype, device=dev)
             for k, p in params.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=zeros, v={k: z.clone() for k, z in zeros.items()})


def learning_rate(cfg: TrainConfig, step):
    """Linear warm-up over ``warmup_steps``, then cosine, linear or
    constant decay to ``total_steps``; fp32, as a tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - t
    else:
        decay = 1.0
    return cfg.learning_rate * warm * decay


def global_norm(tree: Tree):
    return torch.sqrt(sum(x.float().square().sum() for x in tree.values()))


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: g * scale for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(cfg: TrainConfig, params: Tree, grads: Tree,
                 state: OptState):
    """One AdamW step (``optimizer.py:51``): gradients cast to fp32 and
    clipped, ``step + 1`` into the schedule and the bias corrections, then
    ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p)`` on every
    parameter, norm scales and embeddings included. ``params``, ``m`` and
    ``v`` are updated in place. Returns (params, state, {"grad_norm",
    "lr"})."""
    grads = {k: g.float() for k, g in grads.items()}
    gnorm = global_norm(grads)
    # clip_by_global_norm, applied a tensor at a time below
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = learning_rate(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)
    for k, p in params.items():
        g = grads[k] * scale
        m, v = state.m[k], state.v[k]
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        del g
        m.copy_(m32)
        v.copy_(v32)
        mh = m.float() / bc1
        vh = v.float() / bc2
        delta = lr * (mh / (torch.sqrt(vh) + cfg.eps)
                      + cfg.weight_decay * p.float())
        p.copy_(p.float() - delta)
    return params, OptState(step, state.m, state.v), \
        {"grad_norm": gnorm, "lr": lr}
