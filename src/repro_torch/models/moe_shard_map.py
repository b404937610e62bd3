"""Expert-parallel MoE over the data ranks, with explicit all-to-alls.

The port's ``repro/models/moe_shard_map.py``. Where ``moe_apply``
routes the global batch in groups, here each data rank routes only its
own ``T / dp`` tokens and holds ``E / dp`` experts:

    local dispatch  ->  all-to-all  ->  the rank's experts
                    ->  all-to-all  ->  local combine

Each (source rank, expert) pair has ``C_s`` slots, from the source's
token count; an expert's slots go to a source's (token, choice) pairs in
token-major order (``moe.sparse_tables``), and the pairs past ``C_s``
drop to the residual. So the drops are not ``moe_apply``'s once capacity
binds. With ``model_axis`` each expert's hidden width ``f`` is cut over
the model group too, and the experts' partial outputs are summed over it
before they go back. It is a library function, as in the reference: the
serving path runs ``moe_apply``.

The local dispatch keeps dropped pairs out of the send slots, where the
reference scatters each one's zero row onto send slot 0 and may overwrite
a kept row there (``moe_shard_map.py:53-54``, fault R3 in ROADMAP.md):
the two agree wherever nothing drops.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import mlp
from repro_torch.models.moe import (MoE, _experts, capacity, kernels, route,
                                    sparse_tables)


def moe_apply_shard_map(p: MoE, cfg: ModelConfig, x_loc, world, *,
                        model_axis: bool = False,
                        capacity_factor: float = None, impl: str = "torch"
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``moe_shard_map.py:58`` on this rank of ``world`` (a
    ``distributed.context.RankWorld``): ``x_loc`` (T / dp, d) are the
    rank's tokens, the rows of data block d of the global (T, d); ``p``
    holds the router whole and the data rank's experts ``[d * E / dp,
    ...)`` (with ``model_axis``, the model rank's block of their ``f``)
    and a shared MLP as the caller cut it. ``impl="cuda"`` runs the local
    dispatch and combine through K5a/K5b, ``"torch"`` through their plain
    versions. Returns (the rank's output rows, the reference's aux dict:
    every term a mean over the data group, the same on every rank)."""
    e = cfg.moe
    E, k = e.num_experts, e.top_k
    D = world.dp
    if E % D:
        raise ValueError(f"{cfg.name}: {E} experts do not split over "
                         f"{D} data ranks")
    E_loc = E // D
    if p.w_gate.shape[0] != E_loc:
        raise ValueError(f"a rank holds {E_loc} of the {E} experts, not "
                         f"{p.w_gate.shape[0]}")
    T_loc, d = x_loc.shape
    C_s = capacity(T_loc, k, E, capacity_factor or e.capacity_factor)
    logits, probs, gate_vals, gate_idx = route(p.router.kernel, x_loc, k)
    idx, slot, keep = sparse_tables(gate_idx, E, C_s)
    dispatch, combine = kernels(impl)
    send = dispatch(idx, x_loc[None].contiguous())        # (1, E, C_s, d)
    # the block of experts [j * E_loc, ...) goes to data rank j; block j
    # of what comes back holds source j's rows for this rank's experts
    recv = world.all_to_all_data(send.reshape(D, E_loc * C_s * d))
    exp_in = recv.reshape(D, E_loc, C_s, d).transpose(0, 1)
    exp_out = _experts(p, exp_in.reshape(1, E_loc, D * C_s, d))
    if model_axis:
        world.all_reduce_model(exp_out)
    back = exp_out.reshape(E_loc, D, C_s, d).transpose(0, 1)
    mine = world.all_to_all_data(back.reshape(D, E_loc * C_s * d))
    out = combine(slot, gate_vals[None].contiguous(),
                  mine.reshape(1, E, C_s, d))[0].to(x_loc.dtype)
    if p.shared is not None:
        out = out + mlp(p.shared, x_loc)

    def pmean(t):
        return world.all_reduce_data(t) / D

    frac = pmean(F.one_hot(gate_idx[:, 0], E).float().mean(dim=0))
    meanp = pmean(probs.mean(dim=0))
    aux = {"moe_lb_loss": E * torch.sum(frac * meanp),
           "moe_z_loss": pmean(
               torch.logsumexp(logits, dim=-1).square().mean()),
           "moe_drop_frac": pmean(1.0 - keep.float().mean())}
    return out, aux
