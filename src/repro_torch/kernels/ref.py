"""Plain PyTorch versions of the port's kernels.

Each computes the same function as its CUDA kernel (``csrc/*.cu``) with
plain tensor ops: fp32 math, the reference's ``NEG_INF = -1e30`` masking
and a full softmax for attention, whole cosine matrices for the
cross-modal score, indexed gathers for the MoE dispatch and combine.
They follow ``repro/kernels/ref.py:15-113``. The kernel
wrappers in ``ops.py`` run these on CPU tensors; ``chip_smoke.py`` holds
each kernel against them on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _expand(k: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, heads, hd) by repeating each kv head."""
    rep = heads // k.shape[2]
    return k if rep == 1 else torch.repeat_interleave(k, rep, dim=2)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        lengths=None):
    """Prefill attention. q: (B, L, H, hd); k/v: (B, L, Hkv, hd) with
    Hkv | H (Hkv == H is the reference's pre-expanded layout). ``lengths``:
    optional (B,) key lengths; keys at or past them are masked."""
    B, L, H, hd = q.shape
    k = _expand(k, H).float()
    v = _expand(v, H).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * hd ** -0.5
    qp = torch.arange(L, device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    rel = qp - kp
    mask = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        mask &= rel >= 0
    if window > 0:
        mask &= rel < window
    mask = mask[None, None]
    if lengths is not None:
        mask = mask & (kp < lengths.long()[:, None])[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def decode_attention_ref(q, k, v, kv_mask):
    """One query token vs a dense cache. q: (B, 1, H, hd); k/v:
    (B, S, Hkv, hd); kv_mask: (B, S) bool."""
    B, _, H, hd = q.shape
    kx = _expand(k, H).float()
    vx = _expand(v, H).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * hd ** -0.5
    s = torch.where(kv_mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vx).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, block_table, lengths,
                               k_scale=None, v_scale=None):
    """One query token vs KV pages. q: (B, 1, H, hd); pools
    (P, ps, Hkv, hd); block_table (B, n) int32 page ids (clipped to
    [0, P-1]); lengths (B,) live tokens. ``k_scale``/``v_scale``:
    (P, ps, Hkv) fp32 scales of int8/fp8 pools, dequantized after the
    gather."""
    P, ps = k_pages.shape[:2]
    bt = block_table.long().clamp(0, P - 1)
    B, n = bt.shape
    k = k_pages[bt].reshape(B, n * ps, *k_pages.shape[2:])
    v = v_pages[bt].reshape(B, n * ps, *v_pages.shape[2:])
    if k_scale is not None:
        Hkv = k_scale.shape[-1]
        k = k.float() * k_scale[bt].reshape(B, n * ps, Hkv)[..., None]
        v = v.float() * v_scale[bt].reshape(B, n * ps, Hkv)[..., None]
    mask = torch.arange(n * ps, device=q.device)[None, :] < \
        lengths.long()[:, None]
    return decode_attention_ref(q, k, v, mask)



def _unit_rows(x):
    """x / max(|x|, 1e-8) over the last dim, in fp32 (the kernels' rule)."""
    x = x.float()
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-8)


def xmodal_mean_sum_ref(token_embs, mask, visual_feats):
    """K4a's sum: (B,) sum_t mask[t] * sum_j cos(tok_t, vis_j)."""
    sim = torch.einsum("bld,bnd->bln", _unit_rows(token_embs),
                       _unit_rows(visual_feats))
    return (sim.sum(-1) * mask.float()).sum(-1)


def xmodal_max_sum_ref(text_feats, visual_feats):
    """K4b's sum: (B,) sum_r max_j cos(txt_r, vis_j)."""
    sim = torch.einsum("brd,bnd->brn", _unit_rows(text_feats),
                       _unit_rows(visual_feats))
    return sim.amax(-1).sum(-1)


def xmodal_score_ref(token_embs, mask, visual_feats, text_feats):
    """S_align of paper Eq. 8-9 per batch row (``ref.py:78``).
    token_embs: (B, L, d); mask: (B, L); visual_feats: (B, Nv, d);
    text_feats: (B, Nt, d). Rows are normalised as x / max(|x|, 1e-8) in
    fp32; term 1 averages each masked token's cosine over all visual rows,
    term 2 each text row's best visual match. Returns (B,) fp32."""
    tok, vis = _unit_rows(token_embs), _unit_rows(visual_feats)
    txt = _unit_rows(text_feats)
    m = mask.float()
    sim_tv = torch.einsum("bld,bnd->bln", tok, vis)
    term1 = (sim_tv.mean(-1) * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)
    sim_rt = torch.einsum("brd,bnd->brn", txt, vis)
    term2 = sim_rt.amax(-1).mean(-1)
    return 0.5 * (term1 + term2)


def moe_dispatch_ref(idx, x):
    """K5a: idx (G, E, C) int32 token ids (-1 empty); x (G, g, d). Returns
    (G, E, C, d) in x's dtype: slot (e, c) holds row ``x[gr, idx]``, or
    zeros. Ids outside [0, g) are empty, as in the kernel."""
    G, g, _ = x.shape
    valid = (idx >= 0) & (idx < g)
    grp = torch.arange(G, device=x.device)[:, None, None]
    rows = x[grp, idx.long().clamp(0, g - 1)]
    return torch.where(valid[..., None], rows,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def moe_combine_ref(slot, gates, expert_out):
    """K5b: slot (G, g, k) flat E*C slot ids (-1 dropped); gates (G, g, k);
    expert_out (G, E, C, d). Returns (G, g, d) fp32: sum_j gate * row,
    accumulated in j order like the kernel. Ids outside [0, E*C) are
    dropped."""
    G, E, C, d = expert_out.shape
    EC = E * C
    flat = expert_out.reshape(G, EC, d)
    valid = (slot >= 0) & (slot < EC)
    grp = torch.arange(G, device=slot.device)[:, None, None]
    rows = flat[grp, slot.long().clamp(0, EC - 1)].float()   # (G, g, k, d)
    w = torch.where(valid, gates.float(), torch.zeros((), device=slot.device))
    acc = torch.zeros(rows.shape[:2] + (d,), dtype=torch.float32,
                      device=slot.device)
    for j in range(slot.shape[-1]):
        acc = acc + w[..., j, None] * rows[:, :, j]
    return acc
