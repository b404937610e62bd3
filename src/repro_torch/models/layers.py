"""Shared building blocks: norms, RoPE, dense/MLP, embeddings.

Plain functions on tensors, following ``repro/models/layers.py``: weights
keep the reference's (d_in, d_out) "kernel" layout so ``x @ kernel`` is
the same product, and norms and RoPE compute in fp32 and cast back.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def rmsnorm(scale, x, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rmsnorm_headwise(scale, x, eps: float = 1e-6):
    """qk-norm: normalize the last (head) dim with a shared scale."""
    return rmsnorm(scale, x, eps)


# rope frequencies by (head_dim, theta, device): made once, so that a
# decode step captured in a CUDA graph copies nothing from the host
_ROPE_FREQS: Dict[Tuple[int, float, str], torch.Tensor] = {}


def rope_frequencies(head_dim: int, theta: float, device=None):
    key = (head_dim, float(theta), str(torch.device(device or "cpu")))
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        with torch.inference_mode(False):
            exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                                device=device) / head_dim
            freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                                 device=device), exps)
        _ROPE_FREQS[key] = freqs
    return freqs


def apply_rope(x, positions, theta: float):
    """x: (..., L, H, hd); positions: broadcastable to (..., L)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., L, hd/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., L, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense(kernel, x, bias: Optional[torch.Tensor] = None):
    y = x @ kernel
    return y if bias is None else y + bias


def mlp(p, x):
    """p is an ``MLP`` module: SwiGLU (w_gate, w_up, w_down) or a
    non-gated gelu or relu MLP (w_in, w_out). ``jax.nn.gelu`` defaults to
    the tanh approximation, so the gelu here is the tanh form too."""
    if p.activation == "gelu":
        return p.w_out(F.gelu(p.w_in(x), approximate="tanh"))
    if p.activation == "relu":
        return p.w_out(F.relu(p.w_in(x)))
    return p.w_down(F.silu(p.w_gate(x)) * p.w_up(x))


def store_state(dst, new, go=None):
    """Write a recurrent state update into the cache's own storage, cast
    to its dtype: a captured decode step replays fixed addresses, so the
    state is never rebound. ``go``: optional 0-dim bool tensor; when
    False (a masked step of the macro body) the state keeps its value."""
    new = new.to(dst.dtype)
    if go is not None:
        new = torch.where(go, new, dst)
    dst.copy_(new)


def _normal(shape, scale, dtype, device, gen):
    w = torch.randn(shape, generator=gen, device=device,
                    dtype=torch.float32) * scale
    return nn.Parameter(w.to(dtype), requires_grad=False)


class Dense(nn.Module):
    """``x @ kernel (+ bias)`` with a (d_in, d_out) kernel, initialised
    N(0, 1) * d_in^-0.5 like ``repro.models.layers.dense_init``. A
    row-parallel rank's kernel holds its rows of the contracting dim:
    ``reduce_world`` (a ``distributed.context.RankWorld``) then sums the
    partial products over the model group, before the bias. A
    column-parallel rank's kernel holds its columns of the output dim:
    ``gather_world`` then gathers the blocks of the output (bias
    included) over the model group, for a next op that needs it whole."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype=torch.float32, device=None, gen=None):
        super().__init__()
        self.kernel = _normal((d_in, d_out), d_in ** -0.5, dtype, device, gen)
        self.bias = nn.Parameter(torch.zeros(d_out, dtype=dtype,
                                             device=device),
                                 requires_grad=False) if bias else None
        self.reduce_world = None
        self.gather_world = None

    def forward(self, x):
        if self.gather_world is not None:
            return self.gather_world.all_gather_model(
                dense(self.kernel, x, self.bias), dim=-1)
        if self.reduce_world is None:
            return dense(self.kernel, x, self.bias)
        y = self.reduce_world.all_reduce_model(x @ self.kernel)
        return y if self.bias is None else y + self.bias


class Norm(nn.Module):
    """RMSNorm scale holder (the reference's ``{"scale": ones(d)}``)."""

    def __init__(self, d: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)


class MLP(nn.Module):
    """MLP weights as the reference's ``mlp_init``: "swiglu" (w_gate, w_up,
    w_down), "gelu" or "relu" (w_in, w_out)."""

    def __init__(self, d_model: int, d_ff: int, activation: str = "swiglu",
                 *, dtype=torch.float32, device=None, gen=None):
        super().__init__()
        if activation not in ("swiglu", "gelu", "relu"):
            raise ValueError(f"unknown MLP activation {activation!r} "
                             "(swiglu, gelu or relu)")
        self.activation = activation
        kw = dict(dtype=dtype, device=device, gen=gen)
        if activation == "swiglu":
            self.w_gate = Dense(d_model, d_ff, **kw)
            self.w_up = Dense(d_model, d_ff, **kw)
            self.w_down = Dense(d_ff, d_model, **kw)
        else:
            self.w_in = Dense(d_model, d_ff, **kw)
            self.w_out = Dense(d_ff, d_model, **kw)


def embed(table, tokens, start: int = 0, world=None):
    """Rows ``tokens`` of an embedding table. A vocab-parallel rank holds
    rows [start, start + len(table)): tokens outside them give zero rows,
    and the sum over the model group ``world`` gives every token its
    row (``x + 0`` is exact)."""
    if world is None:
        return table[tokens]
    local = tokens - start
    hit = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return world.all_reduce_model(torch.where(hit[..., None], rows,
                                              torch.zeros_like(rows)))


def unembed(x, table, tied: bool):
    """Tied: ``x @ table.T`` over the (V, d) embedding table; untied:
    ``x @ kernel`` over a (d, V) kernel."""
    return x @ table.T if tied else x @ table
