"""Mixture-of-experts MLP with GShard/Switch-style capacity dispatch.

Follows ``repro/models/moe.py``: tokens go in groups of ``group_size``
(the last padded with zero rows), an fp32 router picks each token's top-k
experts with renormalised gates, and each expert takes at most C tokens of
a group, all first choices of the group before any second choice; the rest
are dropped. The reference moves tokens into the (G, E, C) expert slots
and back with one-hot einsums (``moe.py:115``, ``:136``). Here the same
0/1 tables become index tables (slot -> token, (token, choice) -> slot)
and the moves are gathers: kernel K5a/K5b (``kernels/ops.py``) under the
``cuda`` impl, their plain versions (``kernels/ref.py``) under ``torch``.
The expert SwiGLU in between is three batched matrix products.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import MLP, Dense, _normal, mlp


class MoE(nn.Module):
    """Weights as the reference's ``moe_init`` (swiglu): ``router.kernel``
    (d, E) kept in fp32 whatever the parameter dtype, ``w_gate``/``w_up``
    (E, d, f), ``w_down`` (E, f, d) and, with shared experts, the MLP
    ``shared`` of width ``num_shared_experts * f``."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, device=None,
                 gen=None):
        super().__init__()
        e = cfg.moe
        d, f, E = cfg.d_model, e.expert_d_ff, e.num_experts
        self.router = Dense(d, E, dtype=torch.float32, device=device, gen=gen)
        self.w_gate = _normal((E, d, f), d ** -0.5, dtype, device, gen)
        self.w_up = _normal((E, d, f), d ** -0.5, dtype, device, gen)
        self.w_down = _normal((E, f, d), f ** -0.5, dtype, device, gen)
        self.shared = MLP(d, e.num_shared_experts * f, dtype=dtype,
                          device=device, gen=gen) \
            if e.num_shared_experts else None


def capacity(g: int, top_k: int, num_experts: int, cf: float) -> int:
    """Slots per expert and group (``moe.py:61``): at least 8, a multiple
    of 8."""
    c = int(math.ceil(g * top_k / num_experts * cf))
    return max(8, -(-c // 8) * 8)


def route(router_kernel, x, top_k: int):
    """fp32 router logits, softmax probabilities and the renormalised
    top-k gates. x: (..., d). Ties between equal probabilities go to the
    lower expert id, as ``jax.lax.top_k`` breaks them (a stable descending
    sort; ``torch.topk`` leaves their order unspecified, and a zero pad
    row ties all E experts)."""
    logits = x.float() @ router_kernel
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :top_k], idx[..., :top_k]
    vals = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    return logits, probs, vals, idx


def dispatch_tables(gate_idx, num_experts: int, C: int):
    """Index tables of the capacity dispatch, from each token's k expert
    choices ``gate_idx`` (G, g, k). Priority is choice-major: every first
    choice of the group, in token order, before any second choice
    (``moe.py:96-98``); an expert's (c+1)-th assignment takes slot c, and
    those past C are dropped. Integer cumsums, so positions are exact.

    Returns ``idx`` (G, E, C) int32, the token of each slot or -1;
    ``slot`` (G, g, k) int32, the flat e * C + c slot of each choice or -1;
    ``keep`` (G, g, k) bool."""
    G, g, k = gate_idx.shape
    E = num_experts
    choice = gate_idx.transpose(1, 2).reshape(G, k * g)       # a = j * g + t
    onehot = F.one_hot(choice, E).to(torch.int32)            # (G, a, E)
    pos = torch.cumsum(onehot, dim=1).gather(2, choice[..., None])[..., 0] - 1
    keep = pos < C
    flat = torch.where(keep, choice * C + pos, torch.full_like(pos, E * C))
    token = torch.arange(k * g, device=gate_idx.device) % g
    # kept choices own distinct slots; dropped ones land in a spare column
    idx = torch.full((G, E * C + 1), -1, dtype=torch.int32,
                     device=gate_idx.device)
    idx.scatter_(1, flat, token.to(torch.int32).expand(G, -1))
    idx = idx[:, :E * C].reshape(G, E, C).contiguous()
    slot = torch.where(keep, flat, torch.full_like(flat, -1))
    slot = slot.reshape(G, k, g).transpose(1, 2).contiguous()
    return idx, slot.to(torch.int32), keep.reshape(G, k, g).transpose(1, 2)


def _experts(p: MoE, expert_in):
    """The expert SwiGLU over slot rows (G, E, C, d) -> (G, E, C, d), as
    batched products over the E experts. Returns a contiguous tensor, as
    the combine kernel takes it (a copy only when G > 1)."""
    G, E, C, d = expert_in.shape
    x = expert_in.transpose(0, 1).reshape(E, G * C, d)
    h = F.silu(torch.bmm(x, p.w_gate)) * torch.bmm(x, p.w_up)
    y = torch.bmm(h, p.w_down)                            # (E, G * C, d)
    return y.reshape(E, G, C, d).transpose(0, 1).contiguous()


def moe_apply(p: MoE, cfg: ModelConfig, x, *, impl: str = "torch"):
    """x: (..., d). Returns (out like x, routing), as
    ``repro/models/moe.py:66`` with group size and capacity factor from
    ``cfg.moe`` (router noise is a training option and is not ported).
    ``routing`` is (logits, probs, gate_idx, keep), what ``moe_aux`` needs
    for the reference's ``aux`` dict; serving drops it. ``impl="cuda"``
    moves rows through K5a/K5b, ``"torch"`` through their plain versions.

    One step differs from the reference: the combine sums in fp32 with
    fp32 gates, as K5b does, and then casts to x's dtype, where the
    reference's combine einsum runs in x's dtype. The two agree for fp32
    models such as granite-moe-3b-a800m."""
    e = cfg.moe
    E, k = e.num_experts, e.top_k
    orig_shape = x.shape
    d = orig_shape[-1]
    x = x.reshape(-1, d)
    T = x.shape[0]
    g = min(e.group_size, T)
    pad = (-T) % g
    if pad:
        x = torch.cat([x, x.new_zeros(pad, d)])
    G = x.shape[0] // g
    xg = x.reshape(G, g, d)

    logits, probs, gate_vals, gate_idx = route(p.router.kernel, xg, k)
    C = capacity(g, k, E, e.capacity_factor)
    idx, slot, keep = dispatch_tables(gate_idx, E, C)
    if impl == "cuda":
        dispatch, combine = ops.moe_dispatch, ops.moe_combine
    else:
        dispatch, combine = ref.moe_dispatch_ref, ref.moe_combine_ref
    expert_out = _experts(p, dispatch(idx, xg.contiguous()))
    out = combine(slot, gate_vals.contiguous(), expert_out).to(x.dtype)
    out = out.reshape(-1, d)[:T]
    if p.shared is not None:
        out = out + mlp(p.shared, x[:T])
    return out.reshape(orig_shape), (logits, probs, gate_idx, keep)


def moe_aux(logits, probs, gate_idx, keep) -> Dict[str, torch.Tensor]:
    """The reference's ``aux`` dict from ``moe_apply``'s routing: the
    router losses (Switch Transformer eq. 4-6) and the dropped share of
    the (token, choice) pairs, pad rows included as in the reference."""
    E = logits.shape[-1]
    frac_tokens = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    lb_loss = E * torch.sum(frac_tokens * probs.mean(dim=(0, 1)))
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    dropped = 1.0 - keep.sum() / keep.numel()
    return {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss,
            "moe_drop_frac": dropped}


def moe_apply_dense(p: MoE, cfg: ModelConfig, x):
    """Dropless dense oracle (``moe.py:155``): every expert on every token,
    combined with the same renormalised top-k gates. Equals ``moe_apply``
    wherever nothing is dropped."""
    e = cfg.moe
    orig_shape = x.shape
    x = x.reshape(-1, orig_shape[-1])
    _, _, gate_vals, gate_idx = route(p.router.kernel, x, e.top_k)
    full_gate = torch.sum(F.one_hot(gate_idx, e.num_experts).float()
                          * gate_vals[..., None], dim=-2)
    h = F.silu(torch.einsum("td,edf->tef", x, p.w_gate)) \
        * torch.einsum("td,edf->tef", x, p.w_up)
    per_expert = torch.einsum("tef,efd->ted", h, p.w_down)
    out = torch.einsum("te,ted->td", full_gate.to(x.dtype), per_expert)
    if p.shared is not None:
        out = out + mlp(p.shared, x)
    return out.reshape(orig_shape)
