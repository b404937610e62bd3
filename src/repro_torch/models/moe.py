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

On a rank of a serving mesh (``MoE.world``, set by the rank build) the
layer computes the reference's function of the global batch, whichever
way the rule table cut its experts (``sharding.serve_param_specs``):
every rank routes the same global groups, runs its own experts (all of
them, or the data rank's ``E / dp``) on its own cut of their hidden
width ``f`` (all of it, or ``f / model``), combines the slots it holds
(K5b adds nothing for slot ids outside its experts) and sums the partial
outputs over the ranks that share them. ``moe_apply_sparse`` is the
reference's sort/scatter formulation on one device; the expert-parallel
``moe_apply_shard_map`` is in ``models/moe_shard_map.py``.
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
        self.world = None


def expert_range(p: MoE, cfg: ModelConfig, world=None):
    """[e0, e1): the experts a layer holds, all of them but on a rank
    whose data axis cuts them."""
    E_loc = p.w_gate.shape[0]
    e0 = 0 if E_loc == cfg.moe.num_experts else world.coords[0] * E_loc
    return e0, e0 + E_loc


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


def sparse_tables(gate_idx, num_experts: int, C: int):
    """``dispatch_tables`` of one group of T tokens in token-major
    priority, the sort/scatter paths' (``moe.py:212-223``,
    ``moe_shard_map.py:42-51``): an expert's slots go to its (token,
    choice) pairs in the order t * k + j. gate_idx: (T, k). Returns
    ``idx`` (1, E, C) int32 token ids or -1, ``slot`` (1, T, k) int32 flat
    slot ids or -1 and ``keep`` (T, k) bool."""
    T, k = gate_idx.shape
    # one choice a "token" over the T * k pairs gives choice-major order
    # over pairs, which is token-major order over tokens
    idx, slot, keep = dispatch_tables(gate_idx.reshape(1, T * k, 1),
                                      num_experts, C)
    idx = torch.where(idx >= 0, torch.div(idx, k, rounding_mode="floor"),
                      idx)
    return idx, slot.reshape(1, T, k), keep.reshape(T, k)


def _experts(p: MoE, expert_in):
    """The expert SwiGLU over slot rows (G, E, C, d) -> (G, E, C, d), as
    batched products over the E experts. Returns a contiguous tensor, as
    the combine kernel takes it (a copy only when G > 1)."""
    G, E, C, d = expert_in.shape
    x = expert_in.transpose(0, 1).reshape(E, G * C, d)
    h = F.silu(torch.bmm(x, p.w_gate)) * torch.bmm(x, p.w_up)
    y = torch.bmm(h, p.w_down)                            # (E, G * C, d)
    return y.reshape(E, G, C, d).transpose(0, 1).contiguous()


def kernels(impl: str):
    """(dispatch, combine): K5a/K5b under ``cuda``, their plain versions
    under ``torch``."""
    if impl == "cuda":
        return ops.moe_dispatch, ops.moe_combine
    return ref.moe_dispatch_ref, ref.moe_combine_ref


def moe_apply(p: MoE, cfg: ModelConfig, x, *, impl: str = "torch",
              split_rows: bool = False):
    """x: (..., d). Returns (out like x, routing), as
    ``repro/models/moe.py:66`` with group size and capacity factor from
    ``cfg.moe`` (router noise is a training option and is not ported).
    ``routing`` is (logits, probs, gate_idx, keep), what ``moe_aux`` needs
    for the reference's ``aux`` dict; serving drops it. ``impl="cuda"``
    moves rows through K5a/K5b, ``"torch"`` through their plain versions.

    One step differs from the reference: the combine sums in fp32 with
    fp32 gates, as K5b does, and then casts to x's dtype, where the
    reference's combine einsum runs in x's dtype. The two agree for fp32
    models such as granite-moe-3b-a800m.

    On a rank (``p.world``) x's rows are the same on every data rank
    (prefill), or with ``split_rows`` this data rank's block of the batch
    rows (a decode step's slot rows), gathered over the data group first:
    either way every rank routes the reference's global groups, so the
    same pairs drop. Each rank dispatches to its own experts
    (``idx[:, e0:e1]``), runs them on its cut of ``f`` and combines
    through the slot table shifted by ``-e0 * C``; the partial outputs
    are summed over the model group where ``f`` is cut, over the data
    group too where the experts are (over the world for replicated rows,
    by a reduce-scatter to the rank's rows for split ones). Returns the
    rows x came with."""
    e = cfg.moe
    E, k = e.num_experts, e.top_k
    world = p.world
    orig_shape = x.shape
    d = orig_shape[-1]
    x = x.reshape(-1, d)
    own = x.shape[0]
    if world is not None and split_rows:
        x = world.all_gather_data(x)          # the global batch's rows
    T = x.shape[0]
    g = min(e.group_size, T)
    pad = (-T) % g
    xg = torch.cat([x, x.new_zeros(pad, d)]) if pad else x
    G = xg.shape[0] // g
    xg = xg.reshape(G, g, d)

    logits, probs, gate_vals, gate_idx = route(p.router.kernel, xg, k)
    C = capacity(g, k, E, e.capacity_factor)
    idx, slot, keep = dispatch_tables(gate_idx, E, C)
    e0, e1 = expert_range(p, cfg, world)
    split_e = e1 - e0 < E                   # the experts cut on data
    split_f = p.w_gate.shape[2] < e.expert_d_ff      # f cut on model
    if split_e:
        idx = idx[:, e0:e1].contiguous()
        slot = slot - e0 * C              # others' slots fall outside
    dispatch, combine = kernels(impl)
    expert_out = _experts(p, dispatch(idx, xg.contiguous()))
    out = combine(slot, gate_vals.contiguous(), expert_out)
    out = out.reshape(-1, d)[:T]
    # the serving specs cut the experts on the data axis only where they
    # cut f on the model axis (``sharding.check_model_split``)
    r0 = 0 if world is None or not split_rows else world.coords[0] * own
    if split_e and split_rows:
        world.all_reduce_model(out)
        out = world.reduce_scatter_data(out)
    else:
        if split_e:
            world.all_reduce_world(out)
        elif split_f:
            world.all_reduce_model(out)
        out = out[r0:r0 + own]
    out = out.to(x.dtype)
    if p.shared is not None:
        out = out + mlp(p.shared, x[r0:r0 + own])
    return out.reshape(orig_shape), (logits, probs, gate_idx, keep)


def moe_apply_sparse(p: MoE, cfg: ModelConfig, x, *,
                     capacity_factor: float = None, impl: str = "torch"):
    """The reference's sort/scatter MoE (``moe.py:182``) on one device:
    one group of all T tokens, C from T, and token-major capacity
    priority (``sparse_tables``), so its drops differ from ``moe_apply``'s
    once capacity binds; without drops both equal ``moe_apply_dense``.
    Dispatch and combine run K5a/K5b (``impl="cuda"``) or their plain
    versions with G = 1. Returns (out like x, the reference's aux dict).

    Dropped pairs stay out of the expert slots. The reference scatters
    each dropped pair's zero row onto slot 0 (``moe.py:226-228``), where
    it may overwrite the row a kept pair put there (fault R3 in
    ROADMAP.md): the two agree wherever nothing drops."""
    e = cfg.moe
    E, k = e.num_experts, e.top_k
    orig_shape = x.shape
    d = orig_shape[-1]
    x = x.reshape(-1, d)
    T = x.shape[0]
    C = capacity(T, k, E, capacity_factor or e.capacity_factor)
    logits, probs, gate_vals, gate_idx = route(p.router.kernel, x, k)
    idx, slot, keep = sparse_tables(gate_idx, E, C)
    dispatch, combine = kernels(impl)
    expert_out = _experts(p, dispatch(idx, x[None].contiguous()))
    out = combine(slot, gate_vals[None].contiguous(), expert_out)[0]
    out = out.to(x.dtype)
    if p.shared is not None:
        out = out + mlp(p.shared, x)
    return out.reshape(orig_shape), moe_aux(logits[None], probs[None],
                                            gate_idx[None], keep)


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
