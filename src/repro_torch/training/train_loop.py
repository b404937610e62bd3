"""Training step and loop (``repro/training/train_loop.py``).

The model owns its parameters: a train step takes ``params``, the dict of
the model's own named parameters (the tensors its forward reads), and
updates them in place. Training runs the plain ``torch`` impl, the
counterpart of the reference's ``xla`` path: no kernel of the port has a
backward, and ``kernels.ops`` refuses inputs that require grad.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.config import TrainConfig
from repro_torch.models.model import Model
from repro_torch.training.loss import total_loss
from repro_torch.training.optimizer import (OptState, Tree, adamw_update,
                                            init_opt_state)


def batch_to(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors, as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v, device=device)
            for k, v in batch.items()}


def make_loss_fn(model: Model, train_cfg: TrainConfig):
    """loss_fn(batch) -> (loss, metrics) through the model's forward
    (``impl="torch"``, ``remat`` from the config). A vlm config's loss
    leaves out the evidence positions' logits (``train_loop.py:29``)."""
    cfg = model.cfg

    def loss_fn(batch):
        logits, _, aux = model.forward(batch["tokens"], batch.get("evidence"),
                                       remat=train_cfg.remat)
        ne = cfg.num_evidence_tokens
        if ne and not cfg.is_encoder_decoder:
            logits = logits[:, ne:]       # loss over text positions only
        return total_loss(logits, batch["labels"], aux,
                          moe_aux_weight=(cfg.moe.aux_loss_weight
                                          if cfg.moe else 0.0))

    return loss_fn


def _grads(loss, params: Tree) -> Tree:
    """d loss / d each parameter; zeros where the forward did not read it
    (the vision tower's weights when evidence comes precomputed), as
    ``jax.grad`` gives them, so weight decay reaches them too."""
    out = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), out)}


def make_train_step(model: Model, train_cfg: TrainConfig
                    ) -> Callable[..., Tuple[Tree, OptState, Dict]]:
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``params`` the model's named parameters, updated in place.
    With ``microbatches`` k > 1 the batch splits into k equal row blocks
    whose fp32 gradients and metrics accumulate as x / k, the first block
    and then the rest in order (``train_loop.py:48-72``)."""
    loss_fn = make_loss_fn(model, train_cfg)
    k = train_cfg.microbatches
    own = dict(model.named_parameters())

    def grad_fn(params, batch):
        with torch.enable_grad():
            loss, metrics = loss_fn(batch)
            return _grads(loss, params), \
                {n: v.detach() if torch.is_tensor(v) else v
                 for n, v in metrics.items()}

    def train_step(params: Tree, opt_state: OptState, batch):
        if params.keys() != own.keys() or any(
                params[n] is not p for n, p in own.items()):
            raise ValueError("train_step: params must be the model's own "
                             "named parameters, the tensors its forward "
                             "reads")
        if k <= 1:
            grads, metrics = grad_fn(params, batch)
        else:
            B = batch["tokens"].shape[0]
            micro = [{n: x[i * B // k:(i + 1) * B // k]
                      for n, x in batch.items()} for i in range(k)]
            g0, m0 = grad_fn(params, micro[0])
            grads = {n: g.float() / k for n, g in g0.items()}
            metrics = {n: m / k for n, m in m0.items()}
            del g0
            for mb in micro[1:]:
                g, m = grad_fn(params, mb)
                for n in grads:
                    grads[n] = grads[n] + g.pop(n).float() / k
                metrics = {n: metrics[n] + m[n] / k for n in metrics}
        params, opt_state, opt_metrics = adamw_update(
            train_cfg, params, grads, opt_state)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def train(model: Model, train_cfg: TrainConfig, data: Iterator[Dict], *,
          steps: int = 0, log_every: int = 10, callback=None):
    """Single-device training loop: turns ``requires_grad`` on for the
    model's parameters (the port makes them with it off, for serving) and
    takes ``steps`` (default ``total_steps``) AdamW steps on batches from
    ``data`` (numpy or tensors). Returns (params, opt_state, history), a
    history entry of float metrics every ``log_every`` steps and at the
    last."""
    steps = steps or train_cfg.total_steps
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(model, train_cfg)
    history = []
    t0 = time.time()
    for i in range(steps):
        batch = batch_to(next(data), model.device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["elapsed_s"] = time.time() - t0
            history.append(m)
            if callback:
                callback(m)
    return params, opt_state, history
