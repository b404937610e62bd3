"""Grouped-query attention: prefill, the dense ring cache, the paged pool.

Follows ``repro/models/attention.py``. Two implementations of the
attention itself, chosen by ``impl``:
  * ``"torch"`` — ``sdpa``, plain grouped attention in PyTorch ops (the
    counterpart of the reference's ``xla`` path);
  * ``"cuda"``  — the hand-written kernels through ``kernels.ops`` (the
    counterpart of ``pallas``); on CPU tensors ``ops`` runs their plain
    versions.

Activations are (B, L, H, hd), a layer's dense cache (B, S, Hkv, hd) and a
layer's page pool (P, ps, Hkv, hd), as in the reference. Unlike the
reference, cache writes update the given tensors in place.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Dense, apply_rope, rmsnorm_headwise

NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, device=None,
                 gen=None):
        super().__init__()
        hd = cfg.resolved_head_dim
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.wq = Dense(cfg.d_model, cfg.num_heads * hd, bias=cfg.qkv_bias,
                        **kw)
        self.wk = Dense(cfg.d_model, cfg.num_kv_heads * hd,
                        bias=cfg.qkv_bias, **kw)
        self.wv = Dense(cfg.d_model, cfg.num_kv_heads * hd,
                        bias=cfg.qkv_bias, **kw)
        self.wo = Dense(cfg.num_heads * hd, cfg.d_model, **kw)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(hd, dtype=dtype,
                                                  device=device),
                                       requires_grad=False)
            self.k_norm = nn.Parameter(torch.ones(hd, dtype=dtype,
                                                  device=device),
                                       requires_grad=False)


def project_qkv(p: Attention, cfg: ModelConfig, x, positions):
    """q (B, L, H, hd), k and v (B, L, Hkv, hd), roped (and qk-normed per
    head). The head counts are the projections' widths over hd: a model
    rank's H / model and Hkv / model (``sharding.check_model_split``)."""
    B, L, _ = x.shape
    hd = cfg.resolved_head_dim
    q = p.wq(x).reshape(B, L, -1, hd)
    k = p.wk(x).reshape(B, L, -1, hd)
    v = p.wv(x).reshape(B, L, -1, hd)
    if cfg.qk_norm:
        q = rmsnorm_headwise(p.q_norm, q, cfg.norm_eps)
        k = rmsnorm_headwise(p.k_norm, k, cfg.norm_eps)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def sdpa(q, k, v, *, causal: bool, window: int = 0, q_offset: int = 0,
         kv_mask=None, chunk: int = 512):
    """Grouped GQA scaled-dot-product attention (``attention.py:65``).

    q: (B, Lq, Hq, hd); k/v: (B, Lk, Hkv, hd) with Hq % Hkv == 0. The G
    query heads of a kv head share it through the einsum's batch dims, so
    the expanded K/V never exist. Scores and the output product accumulate
    in fp32. ``q_offset``: position of q[0] relative to k[0] (the suffix
    of a prefix-cache hit, a later prefill chunk). ``kv_mask``: optional
    key-validity mask, (B, Lk) shared by the queries or (B, Lq, Lk) per
    query (a speculative verify block, whose query i sees its own
    prefix). Queries go in chunks of ``chunk`` so the Lq x Lk scores stay
    bounded."""
    B, Lq, Hq, hd = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = hd ** -0.5
    kf, vf = k.float(), v.float()
    kv_pos = torch.arange(Lk, device=q.device)
    outs = []
    for c0 in range(0, Lq, chunk):
        qc = q[:, c0:c0 + chunk]
        C = qc.shape[1]
        qg = qc.reshape(B, C, Hkv, G, hd).float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
        q_pos = torch.arange(C, device=q.device) + c0 + q_offset
        rel = q_pos[:, None] - kv_pos[None, :]
        mask = torch.ones_like(rel, dtype=torch.bool)
        if causal:
            mask &= rel >= 0
        if window > 0:
            mask &= rel < window
        neg = torch.full_like(s, NEG_INF)
        s = torch.where(mask[None, None, None], s, neg)
        if kv_mask is not None:
            m = kv_mask[:, None, None, c0:c0 + C] if kv_mask.dim() == 3 \
                else kv_mask[:, None, None, None, :]
            s = torch.where(m, s, neg)
        probs = torch.softmax(s, dim=-1).to(v.dtype).float()
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, vf)
        outs.append(out.reshape(B, C, Hq, hd).to(q.dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def attn_prefill(p: Attention, cfg: ModelConfig, x, positions, *,
                 window: int = 0, impl: str = "torch", lengths=None,
                 ctx_kv=None, q_offset: int = 0, causal: bool = True):
    """Full-sequence attention, causal unless ``causal`` is False (an
    encoder's bidirectional layers, which run ``sdpa`` on every impl, as
    the reference's encoder calls its plain path: ``encdec.py:79``).
    Returns (out (B, L, d), (k, v)) for cache seeding. ``lengths``
    ((B,) int32, optional): the true lengths of
    right-padded rows in a bucketed prefill; keys past them are masked on
    both paths, as the reference's plain path masks them
    (``transformer.py:324``). Real positions never attend to pads anyway
    (causality); masking also pins the pad rows, whose hidden states an
    MoE layer routes and counts against expert capacity.

    ``ctx_kv``: optional (k, v) of context already computed for positions
    [0, q_offset) (a prefix-cache hit's cached pages, the earlier chunks
    of a chunked prefill). The new queries attend causally over [context;
    new] and only the new (k, v) is returned. This runs ``sdpa`` on every
    impl, as the reference does (``attention.py:171-178``): its flash
    kernel takes no context."""
    B, L, _ = x.shape
    q, k, v = project_qkv(p, cfg, x, positions)
    if ctx_kv is not None:
        kc = torch.cat([ctx_kv[0].to(k.dtype), k], dim=1)
        vc = torch.cat([ctx_kv[1].to(v.dtype), v], dim=1)
        out = sdpa(q, kc, vc, causal=True, window=window, q_offset=q_offset)
        return p.wo(out.reshape(B, L, -1)), (k, v)
    if impl == "cuda" and causal:
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  lengths=lengths)
    else:
        kv_mask = None if lengths is None else \
            torch.arange(L, device=x.device)[None, :] < lengths.long()[:, None]
        out = sdpa(q, k, v, causal=causal, window=window, kv_mask=kv_mask)
    return p.wo(out.reshape(B, L, -1)), (k, v)


def cross_attend(p: Attention, cfg: ModelConfig, x, k, v):
    """Cross-attention of a decoder layer (``attention.py:165-170``, and
    at decode ``:533-537``): ``wq`` on x (no rope, no qk-norm), the
    encoder memory's K/V k/v (B, Ne, Hkv, hd), plain ``sdpa`` with no
    mask, then ``wo``. x: (B, L, d), L = 1 at decode. Runs ``sdpa`` on
    every impl, as the reference does."""
    B, L, _ = x.shape
    q = p.wq(x).reshape(B, L, -1, cfg.resolved_head_dim)
    out = sdpa(q, k, v, causal=False)
    return p.wo(out.reshape(B, L, -1))


# ---------------------------------------------------------------------------
# Dense ring cache (one layer: k/v (B, S, Hkv, hd))
# ---------------------------------------------------------------------------

def cache_write(kc, vc, k_new, v_new, pos):
    """Write one token per row at ring slot ``pos % S`` (in place).
    k_new/v_new: (B, 1, Hkv, hd); pos: (B,) int."""
    B, S = kc.shape[:2]
    rows = torch.arange(B, device=kc.device)
    idx = torch.remainder(pos.long(), S)
    kc[rows, idx] = k_new[:, 0].to(kc.dtype)
    vc[rows, idx] = v_new[:, 0].to(vc.dtype)


def cache_write_block(kc, vc, k_new, v_new, pos, valid=None):
    """Write a block of S consecutive tokens per row at ring slots
    ``(pos + i) % S_ring`` (in place; ``attention.py:239``). k_new/v_new:
    (B, S, Hkv, hd) for positions pos..pos+S-1, S <= S_ring, so the slots
    are distinct. ``valid``: optional (B, S); an invalid position's slot
    keeps its value (it is rewritten with what it holds)."""
    B, S = k_new.shape[:2]
    rows = torch.arange(B, device=kc.device)[:, None]
    idx = torch.remainder(pos.long()[:, None] + torch.arange(
        S, device=kc.device)[None, :], kc.shape[1])            # (B, S)
    for c, new in ((kc, k_new), (vc, v_new)):
        new = new.to(c.dtype)
        if valid is not None:
            new = torch.where(valid[:, :, None, None], new, c[rows, idx])
        c[rows, idx] = new


def block_ring_mask(pos, S: int, Sc: int):
    """(B, S, Sc) ring-slot validity for the block's query i at position
    ``pos + i`` (``ring_mask`` per query, full context)."""
    slot = torch.arange(Sc, device=pos.device)
    p = pos.long()[:, None, None] + torch.arange(
        S, device=pos.device)[None, :, None]
    return p - torch.remainder(p - slot[None, None, :], Sc) >= 0


def ring_mask(pos, S: int, window: int = 0):
    """(B, S) validity of ring slots for rows at ``pos``
    (``attention.py:545-556``): slot i holds the position p <= pos with
    p ≡ i (mod S) and p > pos - S."""
    slot = torch.arange(S, device=pos.device)
    p = pos.long()[:, None]
    slot_pos = p - torch.remainder(p - slot[None, :], S)
    valid = slot_pos >= 0
    if window > 0:
        valid &= slot_pos > p - window
    return valid


def attn_decode(p: Attention, cfg: ModelConfig, x, kc, vc, pos, *,
                window: int = 0, impl: str = "torch"):
    """One-token attention against a layer's dense ring cache (written in
    place). x: (B, 1, d); pos: (B,) per-row position of the new token."""
    B = x.shape[0]
    q, k_new, v_new = project_qkv(p, cfg, x, pos[:, None])
    cache_write(kc, vc, k_new, v_new, pos)
    mask = ring_mask(pos, kc.shape[1], window)
    if impl == "cuda":
        out = ops.decode_attention(q, kc, vc, mask)
    else:
        out = sdpa(q, kc, vc, causal=False, kv_mask=mask)
    return p.wo(out.reshape(B, 1, -1))


def prefill_into_cache(kc, vc, k, v):
    """Seed a layer's ring with prefill K/V (B, L, Hkv, hd), in place:
    positions 0..L-1 at the front, or, for a ring shorter than the
    prompt (windowed layers), the last S positions at their ring slots."""
    S, L = kc.shape[1], k.shape[1]
    if L <= S:
        kc[:, :L] = k.to(kc.dtype)
        vc[:, :L] = v.to(vc.dtype)
        return
    slots = torch.remainder(torch.arange(L - S, L, device=kc.device), S)
    kc[:, slots] = k[:, L - S:].to(kc.dtype)
    vc[:, slots] = v[:, L - S:].to(vc.dtype)


# ---------------------------------------------------------------------------
# Quantized KV storage (int8 / fp8-e4m3 with per-row absmax scales)
# ---------------------------------------------------------------------------

KV_DTYPES = ("auto", "fp32", "bf16", "int8", "fp8")
_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def kv_storage_dtype(kv_dtype: str, dtype):
    """Resolve a ``--kv-dtype`` name to (storage dtype, quantized?)."""
    table = {"auto": (dtype, False), "": (dtype, False),
             None: (dtype, False), "fp32": (torch.float32, False),
             "bf16": (torch.bfloat16, False), "int8": (torch.int8, True),
             "fp8": (torch.float8_e4m3fn, True)}
    if kv_dtype not in table:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                         f"got {kv_dtype!r}")
    return table[kv_dtype]


def kv_quantize(x, qdtype):
    """Absmax-quantize KV rows x (..., hd) to int8 or fp8-e4m3
    (``attention.py:307``): one fp32 scale per row, int8 rounds half to
    even and clips to ±127, fp8 casts with round-to-nearest-even."""
    xf = x.float()
    qmax = _QMAX[qdtype]
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-30) / qmax
    y = xf / scale[..., None]
    if qdtype == torch.int8:
        q = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:
        q = y.to(qdtype)
    return q, scale


def kv_dequantize(q, scale):
    return q.float() * scale[..., None].float()


def _raw(t):
    """Byte view of fp8 tensors, whose indexing PyTorch's CPU backend does
    not implement; other dtypes pass through."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


# ---------------------------------------------------------------------------
# Paged pool (one layer: pages (P, ps, Hkv, hd), scales (P, ps, Hkv))
# ---------------------------------------------------------------------------

def _page_slots(pos, block_table, P: int, ps: int):
    n = block_table.shape[1]
    logical = torch.clamp(pos.long() // ps, 0, n - 1)
    page = block_table.long().gather(1, logical[:, None])[:, 0]
    return torch.clamp(page, 0, P - 1), torch.remainder(pos.long(), ps)


def paged_cache_write(kp, vp, k_new, v_new, pos, block_table, ks=None,
                      vs=None):
    """Write one token per row at page ``block_table[b, pos // ps]``,
    offset ``pos % ps`` (in place). Quantized pools (``ks``/``vs`` given)
    store int8/fp8 values and their scales."""
    page, off = _page_slots(pos, block_table, kp.shape[0], kp.shape[1])
    if ks is not None:
        kq, kscale = kv_quantize(k_new[:, 0], kp.dtype)
        vq, vscale = kv_quantize(v_new[:, 0], vp.dtype)
        _raw(kp)[page, off] = _raw(kq)
        _raw(vp)[page, off] = _raw(vq)
        ks[page, off] = kscale
        vs[page, off] = vscale
        return
    kp[page, off] = k_new[:, 0].to(kp.dtype)
    vp[page, off] = v_new[:, 0].to(vp.dtype)


def gather_paged_kv(kp, vp, block_table, ks=None, vs=None):
    """Each row's pages as a contiguous (B, n*ps, Hkv, hd) K/V view,
    dequantized to fp32 for quantized pools."""
    P = kp.shape[0]
    bt = block_table.long().clamp(0, P - 1)
    B = bt.shape[0]
    k = _raw(kp)[bt].view(kp.dtype).reshape(B, -1, *kp.shape[2:])
    v = _raw(vp)[bt].view(vp.dtype).reshape(B, -1, *vp.shape[2:])
    if ks is not None:
        Hkv = ks.shape[-1]
        k = kv_dequantize(k, ks[bt].reshape(B, -1, Hkv))
        v = kv_dequantize(v, vs[bt].reshape(B, -1, Hkv))
    return k, v


def attn_decode_paged(p: Attention, cfg: ModelConfig, x, kp, vp, pos,
                      block_table, *, impl: str = "torch",
                      ks: Optional[torch.Tensor] = None,
                      vs: Optional[torch.Tensor] = None):
    """One-token attention against a layer's page pool (written in place).
    The torch path gathers the pages into the dense view and runs the same
    ``sdpa`` with the same mask as the dense ring (for pos < cache_len the
    ring mask is ``slot <= pos``), so its outputs equal ``attn_decode``'s
    bit for bit; the cuda path runs the paged kernel."""
    B = x.shape[0]
    q, k_new, v_new = project_qkv(p, cfg, x, pos[:, None])
    paged_cache_write(kp, vp, k_new, v_new, pos, block_table, ks, vs)
    lengths = (pos + 1).to(torch.int32)
    if impl == "cuda":
        out = ops.paged_decode_attention(q, kp, vp, block_table, lengths,
                                         k_scale=ks, v_scale=vs)
    else:
        k, v = gather_paged_kv(kp, vp, block_table, ks, vs)
        mask = torch.arange(k.shape[1], device=x.device)[None, :] < \
            lengths[:, None]
        out = sdpa(q, k, v, causal=False, kv_mask=mask)
    return p.wo(out.reshape(B, 1, -1))


def paged_cache_write_block(kp, vp, k_new, v_new, pos, block_table,
                            valid=None, ks=None, vs=None, drop_page: int = 0):
    """Write a block of S consecutive tokens per row through the block
    table in one scatter (in place; ``attention.py:432``). k_new/v_new:
    (B, S, Hkv, hd) for positions pos..pos+S-1, whose (page, offset)
    targets are distinct. ``valid``: optional (B, S); the reference drops
    an invalid position's write, here it goes to ``drop_page``: by default
    the quarantine page 0, which no row reads unmasked, or a sink page no
    row reads at all. Quantized pools store each row quantized with its
    scale."""
    P, ps = kp.shape[:2]
    S = k_new.shape[1]
    p = pos.long()[:, None] + torch.arange(S, device=kp.device)[None, :]
    logical = torch.clamp(p // ps, 0, block_table.shape[1] - 1)
    page = torch.clamp(block_table.long().gather(1, logical), 0, P - 1)
    if valid is not None:
        page = torch.where(valid, page, torch.full_like(page, drop_page))
    off = torch.remainder(p, ps)
    if ks is not None:
        kq, kscale = kv_quantize(k_new, kp.dtype)
        vq, vscale = kv_quantize(v_new, vp.dtype)
        _raw(kp)[page, off] = _raw(kq)
        _raw(vp)[page, off] = _raw(vq)
        ks[page, off] = kscale
        vs[page, off] = vscale
        return
    kp[page, off] = k_new.to(kp.dtype)
    vp[page, off] = v_new.to(vp.dtype)


def attn_decode_block(p: Attention, cfg: ModelConfig, x, cache_k, cache_v,
                      pos, *, block_table=None, valid=None,
                      ks: Optional[torch.Tensor] = None,
                      vs: Optional[torch.Tensor] = None, drop_page: int = 0):
    """Attention of a block of S tokens per row against a layer's cache,
    for speculative verification (``attention.py:565``). x: (B, S, d);
    block token i sits at position ``pos + i``; ``valid`` (B, S): invalid
    positions write no KV (a page pool's go to ``drop_page``) and their
    outputs are to be ignored. With a ``block_table``,
    ``cache_k``/``cache_v`` are the layer's page pool, else its dense
    ring. Query i sees positions <= pos + i, the mask a single-token step
    there would use. Runs ``sdpa`` on every impl, as the reference does:
    the decode kernels take one query a row."""
    B, S, _ = x.shape
    positions = pos.long()[:, None] + torch.arange(S, device=x.device)
    q, k_new, v_new = project_qkv(p, cfg, x, positions)
    if block_table is not None:
        paged_cache_write_block(cache_k, cache_v, k_new, v_new, pos,
                                block_table, valid, ks, vs, drop_page)
        k, v = gather_paged_kv(cache_k, cache_v, block_table, ks, vs)
        mask = torch.arange(k.shape[1], device=x.device)[None, None, :] < \
            (positions + 1)[:, :, None]
    else:
        cache_write_block(cache_k, cache_v, k_new, v_new, pos, valid)
        k, v = cache_k, cache_v
        mask = block_ring_mask(pos, S, k.shape[1])
    out = sdpa(q, k, v, causal=False, kv_mask=mask)
    return p.wo(out.reshape(B, S, -1))
