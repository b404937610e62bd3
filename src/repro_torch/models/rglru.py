"""RecurrentGemma / Griffin recurrent block (RG-LRU, arXiv:2402.19427).

Follows ``repro/models/rglru.py``. The linear recurrence
h_t = a_t h_{t-1} + b_t of a prefill runs as a log-depth (Hillis-Steele)
scan over (log a, b): ceil(log2 L) rounds of whole-sequence elementwise
ops, where the reference runs ``lax.associative_scan`` (another tree of
the same associative combine, so the two agree up to fp32 rounding, not
bit for bit). Decode is one elementwise step, written into the cache in
place (``layers.store_state``). Gates and projections are dense products
outside the scan. Plain PyTorch on every impl: the reference has no
Pallas kernel here either.

On a rank of a model axis (``RGLRU.world``, set by ``Model._wire_rank``)
the block holds its block of the width w: the columns of ``w_x``,
``w_gate``, ``w_a`` and ``w_i``, its channels of the conv and of ``lam``
and its rows of ``out_proj`` (``sharding.rank_specs``). The gates read
the whole conv output, which the rank gathers over the model group once
a layer (``_gates``); the scan and the decode step are elementwise per
channel, and ``out_proj`` sums over the model group.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.layers import Dense, _normal, store_state

_C = 8.0  # RG-LRU decay sharpness constant of the paper


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


class RGLRU(nn.Module):
    """The RG-LRU block's parameters under the reference's names
    (``rglru.py:25-40``); ``lam`` is fp32 whatever the param dtype."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, device=None,
                 gen=None):
        super().__init__()
        w, W, d = _width(cfg), cfg.rglru.conv_width, cfg.d_model
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.w_x = Dense(d, w, **kw)
        self.w_gate = Dense(d, w, **kw)
        self.conv_w = _normal((W, w), W ** -0.5, dtype, device, gen)
        self.conv_b = nn.Parameter(torch.zeros(w, dtype=dtype, device=device),
                                   requires_grad=False)
        self.w_a = Dense(w, w, **kw)          # recurrence gate
        self.w_i = Dense(w, w, **kw)          # input gate
        lam = torch.rand(w, generator=gen, device=device,
                         dtype=torch.float32) * (0.999 - 0.9) + 0.9
        self.lam = nn.Parameter(lam, requires_grad=False)
        self.out_proj = Dense(w, d, **kw)
        self.world = None      # a model rank's world: the gates' gather


def _gates(p: RGLRU, x):
    """x: (..., w) conv output (a model rank's channels). Returns (log_a,
    gated input) in fp32 (``rglru.py:43-52``) of those channels; on a
    model rank ``w_a`` and ``w_i`` take the whole conv output, gathered
    over the model group."""
    x32 = x.float()
    x_all = x if p.world is None else p.world.all_gather_model(x, dim=-1)
    r = torch.sigmoid(p.w_a(x_all).float())
    i = torch.sigmoid(p.w_i(x_all).float())
    # a = exp(-c * softplus(lambda) * r)
    log_a = -_C * F.softplus(p.lam.float()) * r
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a2, 1e-9)) * (i * x32)
    return log_a, b


def linear_scan(log_a, b):
    """h_t = exp(log_a_t) h_{t-1} + b_t from h_{-1} = 0 along axis 1, as a
    Hillis-Steele scan: round k combines each step with the one 2^k
    before it, (la_l, h_l) . (la_r, h_r) = (la_l + la_r,
    exp(la_r) h_l + h_r), the reference's combine."""
    la, h = log_a, b
    L, s = b.shape[1], 1
    while s < L:
        h = torch.cat([h[:, :s], torch.exp(la[:, s:]) * h[:, :-s] + h[:, s:]],
                      dim=1)
        la = torch.cat([la[:, :s], la[:, s:] + la[:, :-s]], dim=1)
        s *= 2
    return h


def rglru_prefill(p: RGLRU, cfg: ModelConfig, u, lengths=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """u: (B, L, d). Returns (out (B, L, d), {"h": (B, w) fp32, "conv":
    (B, W-1, w)}) (``rglru.py:55-97``).

    ``lengths``: optional (B,) int32 true lengths of right-padded rows:
    pad steps become the identity recurrence (log_a = 0, b = 0), so h at
    the last padded step is h at the row's last real step, and each row's
    conv state is gathered at its length. Outputs past a row's length are
    garbage."""
    W = cfg.rglru.conv_width
    B, L, _ = u.shape
    x_in = p.w_x(u)
    gate = F.gelu(p.w_gate(u), approximate="tanh")
    x_pad = torch.cat([x_in.new_zeros(B, W - 1, x_in.shape[-1]), x_in],
                      dim=1)
    conv = sum(x_pad[:, i:i + L] * p.conv_w[i] for i in range(W))
    conv = conv + p.conv_b
    log_a, b = _gates(p, conv)                         # (B, L, w) fp32
    if lengths is not None:
        valid = (torch.arange(L, device=u.device)[None, :] <
                 lengths.long()[:, None])[..., None]
        log_a = torch.where(valid, log_a, 0.0)
        b = torch.where(valid, b, 0.0)
    h = linear_scan(log_a, b)
    out = p.out_proj(h.to(u.dtype) * gate)
    if lengths is None:
        conv_state = x_pad[:, L:L + W - 1]
    else:
        # input j sits at x_pad position j + W - 1 (short rows pick up
        # the left zero-pad)
        idx = lengths.long()[:, None] + torch.arange(W - 1, device=u.device)
        conv_state = x_pad.gather(1, idx[:, :, None].expand(
            -1, -1, x_pad.shape[-1]))
    return out, {"h": h[:, -1], "conv": conv_state}


def make_rglru_state(cfg: ModelConfig, batch: int, dtype, device=None,
                     split: int = 1):
    """Zero state of ``batch`` rows; ``split``: the model ranks the width
    is cut over."""
    w, W = _width(cfg) // split, cfg.rglru.conv_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, W - 1, w), dtype=dtype,
                                device=device)}


def rglru_decode(p: RGLRU, cfg: ModelConfig, u, state, go=None):
    """u: (B, 1, d). One recurrent step (``rglru.py:107-118``): writes the
    new ``state["h"]`` and the shifted ``state["conv"]`` into their own
    storage (unchanged where ``go`` is False) and returns out (B, 1, d)."""
    x_in = p.w_x(u)                                    # (B, 1, w)
    gate = F.gelu(p.w_gate(u), approximate="tanh")
    window = torch.cat([state["conv"].to(x_in.dtype), x_in], dim=1)
    conv = torch.einsum("bwc,wc->bc", window, p.conv_w) + p.conv_b
    log_a, b = _gates(p, conv)                         # (B, w)
    h = torch.exp(log_a) * state["h"] + b
    out = p.out_proj(h[:, None].to(u.dtype) * gate)
    store_state(state["h"], h, go)
    store_state(state["conv"], window[:, 1:], go)
    return out
