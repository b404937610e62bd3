"""Public entry points of the port's kernels: attention (K1-K3), the
cross-modal score (K4) and the MoE dispatch and combine (K5).

Dispatch follows the tensor: on a CPU tensor each wrapper runs the plain
PyTorch version (``ref.py``); on a CUDA tensor it launches its hand-written
kernel (``csrc/*.cu``) or raises. There is no switch that runs the plain
path on the card. No kernel has a backward: a wrapper raises on the card
when grad mode is on and an input requires grad (training runs the plain
impl). Every wrapper checks device, dtype, shape and
contiguity, allocates its output with ``torch.empty``, launches on the
current stream, raises on a nonzero ``cudaGetLastError()``, and adds one to
its entry in ``LAUNCHES``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ref

# launches of each kernel since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "decode_attention": 0,
                            "paged_decode_attention": 0,
                            "xmodal_score_mean": 0, "xmodal_score_max": 0,
                            "moe_dispatch": 0, "moe_combine": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                torch.float8_e4m3fn: 3}
_ACT_DTYPES = (torch.float32, torch.bfloat16)
_FLASH_HD = (16, 32, 64, 128, 256)
# csrc/xmodal_score.cu: K4b's tile (XM_ROWS text x XM_COLS visual rows,
# a block each per split of d) and the columns of d a chunk of its ring
# holds (XM_KC); K4a's columns of d per block of its second pass (XA_COLS)
XM_ROWS, XM_COLS, XM_KC, _XMODAL_MEAN_COLS = 64, 64, 32, 32
# K4b's split plan: the fewest chunks a split takes, and how full the last
# wave of blocks (one an SM) must be
XM_MIN_CHUNKS, XM_WAVE_FILL = 4, 0.9
# the most choices per token csrc/moe_dispatch.cu takes (MC_MAX_K)
_MOE_MAX_K = 32
# split-KV decode plan (csrc/attention_common.cuh): rows per tile
# (DEC_TILE), the most splits (DEC_MAX_SPLIT), the fewest tiles a split
# takes, and the blocks per SM the plan aims for
DEC_TILE, DEC_MAX_SPLIT, DEC_MIN_TILES, DEC_BLOCKS_PER_SM = 16, 64, 4, 16
# the most query heads a decode block serves (a kv head's G above it runs
# in groups, ``decode_groups``), the largest head_dim of both decode
# kernels' usual body, and of the dense kernel's wide one
DEC_MAX_G, DEC_MAX_HD, DEC_WIDE_HD = 8, 128, 256


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(name: str, *tensors: Optional[torch.Tensor]) -> None:
    # no kernel has a backward: its output, written through a raw pointer,
    # would carry no grad_fn and the gradients upstream would go missing
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad and the kernel has no "
            "backward; call it under torch.no_grad() or train through "
            "the plain impl (impl='torch')")
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        _check(t.is_cuda and t.device == dev,
               f"{name}: every tensor must lie on {dev}, got {t.device}")
        _check(t.is_contiguous(), f"{name}: tensors must be contiguous")


def _launch(name: str, *args) -> None:
    from repro_torch.kernels import build
    fn = build.function(name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    lengths=None):
    """Prefill attention. q: (B, L, H, hd); k/v: (B, L, Hkv, hd) with
    Hkv | H, grouped (not expanded). ``lengths``: optional (B,) int32 in
    [1, L]; keys at or past a row's length are masked (the pad keys of a
    length-bucketed prefill). A window shorter than L could then leave a
    pad row with no key, so the two do not go together. Returns
    (B, L, H, hd) in q's dtype."""
    B, L, H, hd = q.shape
    _check(lengths is None or window <= 0 or L <= window,
           "flash_attention: lengths with a window shorter than L")
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       lengths=lengths)
    Hkv = k.shape[2]
    _check_cuda("flash_attention", q, k, v, lengths)
    _check(q.dtype in _ACT_DTYPES and k.dtype == q.dtype and
           v.dtype == q.dtype, "flash_attention: q/k/v fp32 or bf16, alike")
    _check(k.shape == (B, L, Hkv, hd) and v.shape == k.shape and
           H % Hkv == 0, f"flash_attention: bad shapes {q.shape} {k.shape}")
    _check(hd in _FLASH_HD, f"flash_attention: head_dim {hd} not in "
           f"{_FLASH_HD}")
    _check(lengths is None or (lengths.shape == (B,) and
                               lengths.dtype == torch.int32),
           "flash_attention: lengths (B,) int32")
    out = torch.empty_like(q)
    _launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lengths is None else lengths.data_ptr(), out.data_ptr(),
            B, L, H, Hkv, hd, int(causal), int(window),
            _DTYPE_CODES[q.dtype])
    return out


def _check_decode_q(name: str, q, Hkv: int, hd: int,
                    max_hd: int = DEC_MAX_HD) -> None:
    B, one, H, qd = q.shape
    _check(one == 1 and qd == hd and H % Hkv == 0 and hd <= max_hd,
           f"{name}: q {tuple(q.shape)} vs Hkv={Hkv}, hd={hd} (needs "
           f"Hkv | H, head_dim <= {max_hd})")
    _check(q.dtype in _ACT_DTYPES, f"{name}: q must be fp32 or bf16")


def decode_groups(G: int) -> int:
    """Groups the decode kernels cut a kv head's ``G`` query heads into:
    the fewest, of at most ``DEC_MAX_G`` heads each, that divide G (1 for
    G <= 8). Each group runs as a kv head of its own, so the split plan
    counts ``Hkv * decode_groups(G)`` heads."""
    n = -(-G // DEC_MAX_G)
    while G % n:
        n += 1
    return n


def decode_splits(B: int, Hkv: int, S: int, sms: int) -> Tuple[int, int]:
    """Split plan of the decode kernels on a card of ``sms`` SMs:
    (n_split, rows_per_split).

    The cache axis of each (batch row, kv head) is cut into ``n_split``
    runs of ``rows_per_split`` rows, a multiple of ``DEC_TILE`` (the last
    run ragged), so that the grid of B * Hkv * n_split blocks reaches
    ``DEC_BLOCKS_PER_SM * sms``, each split keeps at least
    ``DEC_MIN_TILES`` tiles, and no split is empty. One split for large
    B * Hkv or short S. ``Hkv`` counts the blocks a batch row's split
    takes: the kv heads times their ``decode_groups``.
    """
    tiles = max(1, -(-S // DEC_TILE))
    n = min(-(-DEC_BLOCKS_PER_SM * sms // max(1, B * Hkv)),
            -(-tiles // DEC_MIN_TILES), DEC_MAX_SPLIT)
    per = -(-tiles // max(1, n))
    return -(-tiles // per), per * DEC_TILE


def _split_workspace(q, Hkv: int, n_split: int):
    """The split kernels' fp32 partials (B, Hkv, n_split, H / Hkv, hd + 2),
    merged by the combine kernel; none for one split. (Grouped heads lay
    the same floats out as (B, Hkv, groups, n_split, G / groups, hd + 2).)"""
    if n_split == 1:
        return None
    B, _, H, hd = q.shape
    return torch.empty((B, Hkv, n_split, H // Hkv, hd + 2),
                       dtype=torch.float32, device=q.device)


def _sms(t) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def decode_attention(q, k, v, kv_mask):
    """One query token vs a dense cache. q: (B, 1, H, hd), hd <= 256;
    k/v: (B, S, Hkv, hd) in q's dtype; kv_mask: (B, S) bool. On the card
    the cache axis is split across blocks (``decode_splits``); the splits'
    partials go to an fp32 workspace (B, Hkv, n_split, H / Hkv, hd + 2)
    that a second kernel of the same launch merges. Heads wider than 128
    run the kernel's wide body."""
    if not q.is_cuda:
        return ref.decode_attention_ref(q, k, v, kv_mask)
    B, S, Hkv, hd = k.shape
    _check_cuda("decode_attention", q, k, v, kv_mask)
    _check_decode_q("decode_attention", q, Hkv, hd, DEC_WIDE_HD)
    _check(q.shape[0] == B and v.shape == k.shape and
           kv_mask.shape == (B, S) and kv_mask.dtype == torch.bool and
           k.dtype == q.dtype and v.dtype == q.dtype,
           "decode_attention: k/v (B, S, Hkv, hd) in q's dtype, mask "
           "(B, S) bool")
    n_split, rows = decode_splits(B, Hkv * decode_groups(q.shape[2] // Hkv),
                                  S, _sms(q))
    out = torch.empty_like(q)
    work = _split_workspace(q, Hkv, n_split)
    _launch("decode_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kv_mask.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), B, S, q.shape[2],
            Hkv, hd, n_split, rows, _DTYPE_CODES[q.dtype])
    return out


def paged_decode_attention(q, k_pages, v_pages, block_table, lengths, *,
                           k_scale=None, v_scale=None):
    """One query token vs KV pages. q: (B, 1, H, hd); pools (P, ps, Hkv,
    hd) fp32/bf16/int8/fp8-e4m3; block_table (B, n) int32 (ids clipped to
    [0, P-1]); lengths (B,) int32 (clipped to n * ps). Quantized pools
    need both ``k_scale``/``v_scale`` (P, ps, Hkv) fp32. On the card each
    row's n * ps slots are split across blocks and merged through an fp32
    workspace as in ``decode_attention``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if not q.is_cuda:
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              block_table, lengths,
                                              k_scale=k_scale,
                                              v_scale=v_scale)
    P, ps, Hkv, hd = k_pages.shape
    B, n = block_table.shape
    name = "paged_decode_attention"
    _check_cuda(name, q, k_pages, v_pages, block_table, lengths, k_scale,
                v_scale)
    _check_decode_q(name, q, Hkv, hd)
    quantized = k_pages.dtype in (torch.int8, torch.float8_e4m3fn)
    _check(k_pages.dtype in _DTYPE_CODES and v_pages.dtype == k_pages.dtype
           and v_pages.shape == k_pages.shape,
           f"{name}: pools alike, fp32/bf16/int8/fp8")
    _check(quantized == (k_scale is not None),
           f"{name}: int8/fp8 pools need scales, others take none")
    if quantized:
        _check(k_scale.shape == (P, ps, Hkv) and v_scale.shape == (P, ps, Hkv)
               and k_scale.dtype == torch.float32 and
               v_scale.dtype == torch.float32,
               f"{name}: scales (P, ps, Hkv) fp32")
    _check(q.shape[0] == B and block_table.dtype == torch.int32 and
           lengths.shape == (B,) and lengths.dtype == torch.int32,
           f"{name}: block_table (B, n) int32, lengths (B,) int32")
    # planned from the block table's capacity, never from the lengths:
    # reading them on the host would wait for the device at every decode
    # step; splits past a row's length copy nothing and weigh nothing
    n_split, rows = decode_splits(B, Hkv * decode_groups(q.shape[2] // Hkv),
                                  n * ps, _sms(q))
    out = torch.empty_like(q)
    work = _split_workspace(q, Hkv, n_split)
    _launch(name, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), B, q.shape[2], Hkv,
            hd, P, ps, n, n_split, rows, _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[k_pages.dtype])
    return out


def _check_xmodal(name: str, rows, vis) -> None:
    B, n, d = rows.shape
    _check(rows.dtype in _ACT_DTYPES and vis.dtype == rows.dtype,
           f"{name}: rows and visual rows fp32 or bf16, alike")
    _check(vis.dim() == 3 and vis.shape[0] == B and vis.shape[2] == d and
           min(n, vis.shape[1], d) > 0,
           f"{name}: bad shapes {tuple(rows.shape)} {tuple(vis.shape)}")


def xmodal_mean_sum(token_embs, mask, visual_feats):
    """K4a: (B,) fp32 sum_t mask[t] * sum_j cos(tok_t, vis_j). token_embs:
    (B, L, d); mask: (B, L) fp32; visual_feats: (B, Nv, d), fp32 or bf16
    like token_embs. On the card two kernels compute it factored, as
    sum_t mask[t] inv_t tok_t . (sum_j inv_j vis_j), through an fp32
    workspace of the rows' inverse norms and the d chunks' partials."""
    if not token_embs.is_cuda:
        return ref.xmodal_mean_sum_ref(token_embs, mask, visual_feats)
    name = "xmodal_score_mean"
    _check_cuda(name, token_embs, mask, visual_feats)
    _check_xmodal(name, token_embs, visual_feats)
    B, L, d = token_embs.shape
    Nv = visual_feats.shape[1]
    _check(mask.shape == (B, L) and mask.dtype == torch.float32,
           f"{name}: mask must be ({B}, {L}) fp32")
    dev = token_embs.device
    out = torch.empty(B, dtype=torch.float32, device=dev)
    ticket = torch.empty(B, dtype=torch.int32, device=dev)   # zeroed there
    work = torch.empty(B * (L + Nv + -(-d // _XMODAL_MEAN_COLS)),
                       dtype=torch.float32, device=dev)
    _launch(name, token_embs.data_ptr(), mask.data_ptr(),
            visual_feats.data_ptr(), work.data_ptr(), ticket.data_ptr(),
            out.data_ptr(), B, L, Nv, d, _DTYPE_CODES[token_embs.dtype])
    return out


def xmodal_max_splits(B: int, Nt: int, Nv: int, d: int,
                      sms: int) -> Tuple[int, int]:
    """Split plan of K4b on a card of ``sms`` SMs: (n_split,
    cols_per_split).

    d is cut into ``n_split`` runs of ``cols_per_split`` columns, a
    multiple of ``XM_KC`` (the last run ragged), each of at least
    ``XM_MIN_CHUNKS`` chunks and none empty. One block of the kernel keeps
    an SM busy (a second block on it gains little), so the grid of
    B * tiles * n_split blocks (tiles = ceil(Nt / XM_ROWS) *
    ceil(Nv / XM_COLS)) takes about as long as its busiest SM's blocks, each
    one split's work: the plan takes
    the fewest splits whose last wave is at least ``XM_WAVE_FILL`` full,
    else the fullest. One split where the tiles fill the card or d is
    short.
    """
    tiles = B * -(-Nt // XM_ROWS) * -(-Nv // XM_COLS)
    chunks = -(-d // XM_KC)
    best = (0.0, 1, chunks)
    for n in range(1, max(1, chunks // XM_MIN_CHUNKS) + 1):
        per = -(-chunks // n)
        n_split = -(-chunks // per)
        blocks = tiles * n_split
        fill = blocks / (-(-blocks // sms) * sms)
        if fill >= XM_WAVE_FILL:
            return n_split, per * XM_KC
        if fill > best[0]:
            best = (fill, n_split, per)
    return best[1], best[2] * XM_KC


def _xmodal_max_work(B: int, Nt: int, Nv: int, n_split: int) -> int:
    """Floats of K4b's workspace: each split's partial dot tile and
    squared norms (none for one split), then the rows' maxima per visual
    tile."""
    tiles_v = -(-Nv // XM_COLS)
    parts = B * -(-Nt // XM_ROWS) * tiles_v * n_split if n_split > 1 else 0
    return parts * (XM_ROWS * XM_COLS + XM_ROWS + XM_COLS) + B * tiles_v * Nt


# K4b's tickets, per (device, stream): the kernel takes each from zero and
# leaves it at zero (atomicInc wraps at its last block), so a buffer is
# zeroed once, when it is made, and calls need no fill launch. Calls on one
# stream run in order and never share a ticket at once.
_XMODAL_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _xmodal_tickets(dev, n: int) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _XMODAL_TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=dev)
        _XMODAL_TICKETS[key] = buf
    return buf


def xmodal_max_sum(text_feats, visual_feats):
    """K4b: (B,) fp32 sum_r max_j cos(txt_r, vis_j). text_feats:
    (B, Nt, d); visual_feats: (B, Nv, d), fp32 or bf16 alike. On the card
    one kernel computes it on the tensor cores over d cut by
    ``xmodal_max_splits``; the splits' partials go to an fp32 workspace,
    folded by the tile's last block."""
    if not text_feats.is_cuda:
        return ref.xmodal_max_sum_ref(text_feats, visual_feats)
    name = "xmodal_score_max"
    _check_cuda(name, text_feats, visual_feats)
    _check_xmodal(name, text_feats, visual_feats)
    B, Nt, d = text_feats.shape
    Nv = visual_feats.shape[1]
    dev = text_feats.device
    n_split, cols = xmodal_max_splits(B, Nt, Nv, d, _sms(text_feats))
    out = torch.empty(B, dtype=torch.float32, device=dev)
    tiles = -(-Nt // XM_ROWS) * -(-Nv // XM_COLS)
    ticket = _xmodal_tickets(dev, B * tiles + B)
    work = torch.empty(_xmodal_max_work(B, Nt, Nv, n_split),
                       dtype=torch.float32, device=dev)
    _launch(name, text_feats.data_ptr(), visual_feats.data_ptr(),
            work.data_ptr(), ticket.data_ptr(), out.data_ptr(), B, Nt, Nv, d,
            n_split, cols, _DTYPE_CODES[text_feats.dtype])
    return out


def xmodal_score(token_embs, mask, visual_feats, text_feats):
    """S_align of paper Eq. 8-9 per batch row: token_embs (B, L, d); mask
    (B, L) fp32; visual_feats (B, Nv, d); text_feats (B, Nt, d). Returns
    (B,) fp32 0.5 * (sum1 / (max(sum mask, 1) * Nv) + sum2 / Nt), with
    sum1 from K4a and sum2 from K4b."""
    if not token_embs.is_cuda:
        return ref.xmodal_score_ref(token_embs, mask, visual_feats,
                                    text_feats)
    _check(text_feats.dtype == token_embs.dtype,
           "xmodal_score: token and text rows alike")
    sum1 = xmodal_mean_sum(token_embs, mask, visual_feats)
    sum2 = xmodal_max_sum(text_feats, visual_feats)
    n_tok = torch.clamp(mask.sum(-1), min=1.0)
    return 0.5 * (sum1 / (n_tok * visual_feats.shape[1]) +
                  sum2 / text_feats.shape[1])


def moe_dispatch(idx, x):
    """K5a: expert inputs (G, E, C, d) in x's dtype. Slot (e, c) of group
    gr holds row ``x[gr, idx[gr, e, c]]``, or zeros where the id is -1
    (ids outside [0, g) are empty too). idx: (G, E, C) int32; x:
    (G, g, d) fp32 or bf16."""
    if not x.is_cuda:
        return ref.moe_dispatch_ref(idx, x)
    name = "moe_dispatch"
    _check_cuda(name, x, idx)
    _check(x.dtype in _ACT_DTYPES, f"{name}: x must be fp32 or bf16")
    _check(idx.dtype == torch.int32 and idx.dim() == 3 and x.dim() == 3 and
           idx.shape[0] == x.shape[0] and min(idx.shape) > 0 and
           min(x.shape) > 0,
           f"{name}: idx (G, E, C) int32 and x (G, g, d), got "
           f"{tuple(idx.shape)} {idx.dtype} {tuple(x.shape)}")
    G, E, C = idx.shape
    g, d = x.shape[1:]
    out = torch.empty((G, E, C, d), dtype=x.dtype, device=x.device)
    _launch(name, idx.data_ptr(), x.data_ptr(), out.data_ptr(), G, E, C, g,
            d, x.element_size())
    return out


def moe_combine(slot, gates, expert_out):
    """K5b: (G, g, d) fp32 ``sum_j gates[.., j] * row(slot[.., j])`` over
    each token's k choices, in j order; -1 (dropped) and other ids outside
    [0, E*C) add nothing. slot: (G, g, k) int32 flat E*C slot ids; gates:
    (G, g, k) fp32; expert_out: (G, E, C, d) fp32 or bf16."""
    if not expert_out.is_cuda:
        return ref.moe_combine_ref(slot, gates, expert_out)
    name = "moe_combine"
    _check_cuda(name, expert_out, slot, gates)
    _check(expert_out.dtype in _ACT_DTYPES and gates.dtype == torch.float32
           and slot.dtype == torch.int32,
           f"{name}: slot int32, gates fp32, expert_out fp32 or bf16")
    _check(slot.dim() == 3 and gates.shape == slot.shape and
           expert_out.dim() == 4 and expert_out.shape[0] == slot.shape[0]
           and min(slot.shape) > 0 and min(expert_out.shape) > 0,
           f"{name}: slot and gates (G, g, k), expert_out (G, E, C, d), got "
           f"{tuple(slot.shape)} {tuple(gates.shape)} "
           f"{tuple(expert_out.shape)}")
    G, g, k = slot.shape
    _, E, C, d = expert_out.shape
    _check(k <= _MOE_MAX_K, f"{name}: k {k} > {_MOE_MAX_K}")
    out = torch.empty((G, g, d), dtype=torch.float32, device=slot.device)
    _launch(name, slot.data_ptr(), gates.data_ptr(), expert_out.data_ptr(),
            out.data_ptr(), G, g, k, E * C, d,
            _DTYPE_CODES[expert_out.dtype])
    return out
