"""Mamba-2 block (SSD, state-space duality, arXiv:2405.21060).

Follows ``repro/models/ssm.py``. Prefill runs the chunked SSD form: the
within-chunk terms are dense products over chunks of ``chunk_size``
steps, and the recurrence between chunks is a Python loop over the
L / Q chunk states (the reference's ``lax.scan``). Decode is the O(1)
recurrent step on a (B, H, P, N) state, written into the cache in place
(``layers.store_state``). Single B/C group, as in the 780m config.

On a rank of a model axis (``SSM.world``, set by ``Model._wire_rank``)
the block holds its block of the heads: its z, x and dt columns of
``in_proj``, its x channels of the conv (the B and C channels whole, so
every model rank computes them alike), its heads' ``A_log``, ``D``,
``dt_bias`` and ``norm`` channels and its rows of ``out_proj``
(``sharding.rank_specs``). Its dims are read off those parameters
(``_local_dims``). The gated norm is an RMS over the whole inner width:
a rank sums its channels' squares over the model group and divides by
the whole width, once a layer; ``out_proj`` sums over the model group.

The JAX package computes both forms in plain XLA ops, outside any Pallas
kernel, so they stay plain PyTorch here on every impl.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.layers import Dense, _normal, store_state


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    heads = inner // s.head_dim
    return inner, heads, s.head_dim, s.state_dim, s.conv_width


def _local_dims(p: "SSM", cfg: ModelConfig):
    """``_dims`` of the block as held: a model rank's inner channels and
    heads (its ``norm`` and ``A_log``), the config's P, N and W."""
    _, _, P, N, W = _dims(cfg)
    return p.norm.shape[0], p.A_log.shape[0], P, N, W


class SSM(nn.Module):
    """The SSD block's parameters under the reference's names
    (``ssm.py:26-40``); ``A_log``, ``D`` and ``dt_bias`` are fp32 whatever
    the param dtype."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, device=None,
                 gen=None):
        super().__init__()
        inner, H, P, N, W = _dims(cfg)
        d = cfg.d_model
        kw = dict(dtype=dtype, device=device, gen=gen)
        conv_ch = inner + 2 * N

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        self.in_proj = Dense(d, 2 * inner + 2 * N + H, **kw)
        self.conv_w = _normal((W, conv_ch), W ** -0.5, dtype, device, gen)
        self.conv_b = param(torch.zeros(conv_ch, dtype=dtype, device=device))
        self.A_log = param(torch.log(torch.linspace(
            1.0, 16.0, H, dtype=torch.float32, device=device)))
        self.D = param(torch.ones(H, dtype=torch.float32, device=device))
        self.dt_bias = param(torch.zeros(H, dtype=torch.float32,
                                         device=device))
        self.norm = param(torch.ones(inner, dtype=dtype, device=device))
        self.out_proj = Dense(inner, d, **kw)
        self.world = None      # a model rank's world: the norm's sum


def _segsum(a):
    """a: (..., Q). Returns (..., Q, Q) with L[i, j] = sum_{k=j+1..i} a_k
    for i >= j, -inf above the diagonal (its exp is exactly 0)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device))
    return seg.masked_fill(~mask, -math.inf)


def _split_proj(p: SSM, cfg: ModelConfig, u):
    inner, H, P, N, W = _local_dims(p, cfg)
    zxbcdt = p.in_proj(u)
    return torch.split(zxbcdt, [inner, inner + 2 * N, H], dim=-1)


def _gated_norm(p: SSM, cfg: ModelConfig, y, z, eps: float):
    """RMS-normalise ``y * silu(z)`` over the whole inner width: on a
    model rank its channels' sum of squares summed over the model
    group."""
    y = y * F.silu(z)
    y32 = y.float()
    if p.world is None:
        var = y32.square().mean(dim=-1, keepdim=True)
    else:
        var = p.world.all_reduce_model(
            y32.square().sum(dim=-1, keepdim=True)) / _dims(cfg)[0]
    y32 = y32 * torch.rsqrt(var + eps)
    return (y32 * p.norm.float()).to(z.dtype)


def ssm_prefill(p: SSM, cfg: ModelConfig, u, lengths=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """u: (B, L, d). Returns (y (B, L, d), {"ssd": (B, H, P, N) fp32,
    "conv": (B, W-1, inner + 2N)}), the state that seeds decode
    (``ssm.py:71-168``).

    ``lengths``: optional (B,) int32 true lengths of right-padded rows.
    Pad steps get dt = 0 (identity transition, no contribution) and each
    row's conv tail is gathered at its length, so each row's state
    matches a prefill of that row alone up to summation order; outputs
    past a row's length are garbage."""
    inner, H, P, N, W = _local_dims(p, cfg)
    Bsz, Lreal, _ = u.shape
    Q = min(cfg.ssm.chunk_size, Lreal)
    Lpad = (-Lreal) % Q
    L = Lreal + Lpad
    dev = u.device

    z, xbc, dt = _split_proj(p, cfg, u)
    ch = xbc.shape[-1]
    if lengths is None:
        conv_tail = xbc[:, max(0, Lreal - (W - 1)):]   # decode seed
        if Lreal < W - 1:      # short prompt: left-pad the window with 0
            conv_tail = torch.cat([xbc.new_zeros(Bsz, W - 1 - Lreal, ch),
                                   conv_tail], dim=1)
    if Lpad:
        xbc = torch.cat([xbc, xbc.new_zeros(Bsz, Lpad, ch)], dim=1)
        dt = torch.cat([dt, dt.new_zeros(Bsz, Lpad, H)], dim=1)
    nc = L // Q
    # causal depthwise conv over [x, B, C]
    xbc_pad = torch.cat([xbc.new_zeros(Bsz, W - 1, ch), xbc], dim=1)
    if lengths is not None:
        # input j sits at pad position j + W - 1: each row's last W - 1
        # real inputs (rows shorter than W - 1 pick up the left zeros)
        idx = lengths.long()[:, None] + torch.arange(W - 1, device=dev)
        conv_tail = xbc_pad.gather(1, idx[:, :, None].expand(-1, -1, ch))
    conv = sum(xbc_pad[:, i:i + L] * p.conv_w[i] for i in range(W))
    conv = F.silu(conv + p.conv_b)
    x, B_in, C_in = torch.split(conv, [inner, N, N], dim=-1)

    x = x.reshape(Bsz, L, H, P)
    dt = F.softplus(dt.float() + p.dt_bias)                     # (B, L, H)
    if lengths is not None:
        valid = torch.arange(L, device=dev)[None, :] < lengths.long()[:, None]
        dt = torch.where(valid[..., None], dt, 0.0)
    elif Lpad:
        valid = torch.arange(L, device=dev) < Lreal
        dt = torch.where(valid[None, :, None], dt, 0.0)
    A = -torch.exp(p.A_log)                                     # (H,)
    dA = dt * A                                                 # (B, L, H)
    xbar = x.float() * dt[..., None]                            # (B, L, H, P)
    Bc = B_in.float().reshape(Bsz, nc, Q, N)
    Cc = C_in.float().reshape(Bsz, nc, Q, N)

    dA_c = dA.reshape(Bsz, nc, Q, H).permute(0, 3, 1, 2)        # (B, H, nc, Q)
    x_c = xbar.reshape(Bsz, nc, Q, H, P)
    dA_cumsum = torch.cumsum(dA_c, dim=-1)
    Lmat = torch.exp(_segsum(dA_c))                             # (B,H,nc,Q,Q)
    # within-chunk (diagonal blocks): sum_s C_l.B_s Lmat[l, s] x_s
    cb = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", cb[:, None] * Lmat, x_c)
    # per-chunk end states
    decay_states = torch.exp(dA_cumsum[..., -1:] - dA_cumsum)   # (B,H,nc,Q)
    states = torch.einsum("bclhp,bcln->bchpn",
                          x_c * decay_states.permute(0, 2, 3, 1)[..., None],
                          Bc)
    chunk_decay = torch.exp(dA_cumsum[..., -1])                 # (B, H, nc)

    # recurrence between chunks: the state entering each chunk
    prev = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=dev)
    states_in = []
    for c in range(nc):
        states_in.append(prev)
        prev = prev * chunk_decay[:, :, c, None, None] + states[:, c]
    states_in = torch.stack(states_in, dim=1)                   # (B,nc,H,P,N)

    state_decay_out = torch.exp(dA_cumsum).permute(0, 2, 3, 1)  # (B,nc,Q,H)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, states_in) * \
        state_decay_out[..., None]

    y = (y_diag + y_off).reshape(Bsz, L, H, P)
    y = y + x.float() * p.D[None, None, :, None]
    y = y.reshape(Bsz, L, inner)[:, :Lreal].to(u.dtype)
    y = _gated_norm(p, cfg, y, z, cfg.norm_eps)
    return p.out_proj(y), {"ssd": prev, "conv": conv_tail}


def make_ssm_state(cfg: ModelConfig, batch: int, dtype, device=None,
                   split: int = 1):
    """Zero state of ``batch`` rows; ``split``: the model ranks the heads
    and x channels are cut over (B and C channels whole)."""
    inner, H, P, N, W = _dims(cfg)
    inner, H = inner // split, H // split
    return {"ssd": torch.zeros((batch, H, P, N), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, W - 1, inner + 2 * N), dtype=dtype,
                                device=device)}


def ssm_decode(p: SSM, cfg: ModelConfig, u, state, go=None):
    """u: (B, 1, d). The O(1) recurrent step (``ssm.py:179-200``): writes
    the new ``state["ssd"]`` and the shifted ``state["conv"]`` into their
    own storage (unchanged where ``go`` is False) and returns y (B, 1,
    d)."""
    inner, H, P, N, W = _local_dims(p, cfg)
    Bsz = u.shape[0]
    z, xbc, dt = _split_proj(p, cfg, u)                         # (B, 1, .)
    window = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)
    conv = F.silu(torch.einsum("bwc,wc->bc", window, p.conv_w) + p.conv_b)
    x, B_in, C_in = torch.split(conv, [inner, N, N], dim=-1)
    x = x.reshape(Bsz, H, P).float()
    dt1 = F.softplus(dt[:, 0].float() + p.dt_bias)              # (B, H)
    dA = torch.exp(dt1 * -torch.exp(p.A_log))                   # (B, H)
    Bc, Cc = B_in.float(), C_in.float()
    ssd = state["ssd"] * dA[..., None, None] + \
        torch.einsum("bhp,bn->bhpn", x * dt1[..., None], Bc)
    y = torch.einsum("bhpn,bn->bhp", ssd, Cc) + x * p.D[None, :, None]
    y = y.reshape(Bsz, 1, inner).to(u.dtype)
    y = _gated_norm(p, cfg, y, z, cfg.norm_eps)
    store_state(state["ssd"], ssd, go)
    store_state(state["conv"], window[:, 1:], go)
    return p.out_proj(y)
