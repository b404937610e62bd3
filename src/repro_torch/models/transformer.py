"""Decoder-only stacks of attention, SSD and RG-LRU blocks: the
full-sequence forward, cache layouts, prefill and decode.

Follows ``repro/models/transformer.py``, with a Python loop over layers
where the reference scans over stacked super-blocks. Each layer runs its
kind's block (``block_pattern`` tiled over the layers): full or windowed
attention (``ATTN``: ``cfg.attn_window``), sliding-window attention
(``LOCAL_ATTN``: ``cfg.local_window``), the Mamba-2 SSD block (``SSM``,
no MLP) or the RG-LRU block (``RGLRU``). Caches stack each kind's
per-layer tensors on a leading axis over the layers of that kind:

  dense: {"k", "v": (n_attn, B, S_ring, Hkv, hd),     attention layers
          "ssd": (n_ssm, B, H, P, N) fp32,            SSD state
          "ssm_conv": (n_ssm, B, W-1, inner + 2N),    SSD conv tail
          "h": (n_rglru, B, w) fp32,                  RG-LRU state
          "rglru_conv": (n_rglru, B, W-1, w),         RG-LRU conv tail
          "pos": (B,) int32}
  paged (attention-only stacks):
         {"k_pages", "v_pages": (num_layers, P, ps, Hkv, hd),
          ["k_scale", "v_scale": (num_layers, P, ps, Hkv) fp32,]
          "pos": (B,) int32, "block_table": (B, cache_len // ps) int32}

with only the leaves of the kinds the stack has. ``cache["k"][j]`` is the
j-th attention layer's (B, S_ring, Hkv, hd) ring, S_ring = cache_len, or
min(cache_len, window) for windowed layers (every attention layer of a
stack has the same ring); ``cache["k_pages"][l]`` is layer l's
(P, ps, Hkv, hd) pool. Every leaf but ``pos`` has its batch on axis 1,
so that a cache row moves leaf by leaf. Prefill and decode update the
cache tensors in place and return the same dict; decode writes recurrent
state with ``copy_`` into the cache's own storage, as a captured decode
graph needs. A model rank's cache holds its block of each leaf
(``Model.make_cache``): Hkv / model kv heads, or the one kv head whole;
H / model SSD heads and inner / model + 2N conv channels; w / model of
the RG-LRU width.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ATTN, LOCAL_ATTN, RGLRU, SSM, ModelConfig
from repro_torch.distributed.context import constrain_logits
from repro_torch.models import attention as attn_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import mlp, rmsnorm, unembed
from repro_torch.models.moe import moe_apply, moe_aux

# the cache leaf of each part of a recurrent kind's state
_STATE_LEAVES = {SSM: {"ssd": "ssd", "conv": "ssm_conv"},
                 RGLRU: {"h": "h", "conv": "rglru_conv"}}


def has_mlp(cfg: ModelConfig, kind: str) -> bool:
    """Attention and RG-LRU blocks carry an MLP, SSD blocks none
    (``transformer.py:36-37``)."""
    return kind in (ATTN, LOCAL_ATTN, RGLRU) and \
        (cfg.d_ff > 0 or cfg.moe is not None)


def window_for(cfg: ModelConfig, kind: str) -> int:
    return cfg.attn_window if kind == ATTN else cfg.local_window


def layer_slots(cfg: ModelConfig) -> Tuple[List[Tuple[str, int]],
                                           Dict[str, int]]:
    """Each layer's (kind, index along its cache leaves' layer axis), and
    the number of layers a leaf group stacks ("attn" for both attention
    kinds, SSM, RGLRU)."""
    counts: Dict[str, int] = {}
    slots = []
    for kind in cfg.layer_kinds:
        group = "attn" if kind in (ATTN, LOCAL_ATTN) else kind
        slots.append((kind, counts.get(group, 0)))
        counts[group] = counts.get(group, 0) + 1
    return slots, counts


def ring_lens(cfg: ModelConfig, cache_len: int) -> set:
    """The ring lengths of the stack's attention layers (``transformer.py:
    122-129``): cache_len for full-context attention, else
    min(cache_len, the layer's window)."""
    return {cache_len if kind == ATTN and cfg.attn_window == 0 else
            min(cache_len, window_for(cfg, kind))
            for kind in cfg.layer_kinds if kind in (ATTN, LOCAL_ATTN)}


def _ring_len(cfg: ModelConfig, cache_len: int) -> int:
    """The one ring of the stack's attention layers: rings of different
    lengths do not stack."""
    rings = ring_lens(cfg, cache_len)
    if len(rings) > 1:
        raise NotImplementedError(
            f"{cfg.name}: attention layers with rings of {sorted(rings)} "
            f"slots at cache_len {cache_len} do not stack in one cache")
    return rings.pop() if rings else cache_len


def make_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device,
               kv_heads: int = 0, split: int = 1):
    """``kv_heads``: the kv heads a layer caches (0: the config's; a model
    rank caches its Hkv / model, or the one kv head whole). ``split``: the
    model ranks an SSD block's heads and an RG-LRU block's width are cut
    over (a rank's state leaves hold its block)."""
    _, n = layer_slots(cfg)
    cache = {}
    if n.get("attn"):
        shape = (n["attn"], batch, _ring_len(cfg, cache_len),
                 kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    for kind, make in ((SSM, ssm_lib.make_ssm_state),
                       (RGLRU, rglru_lib.make_rglru_state)):
        if n.get(kind):
            state = make(cfg, n[kind] * batch, dtype, device, split=split)
            for key, t in state.items():
                cache[_STATE_LEAVES[kind][key]] = t.reshape(
                    (n[kind], batch) + t.shape[1:])
    cache["pos"] = torch.zeros(batch, dtype=torch.int32, device=device)
    return cache


def _state_of(cache, kind: str, j: int):
    """Layer j's recurrent state as the block functions name it: views of
    the stacked leaves, so that writes land in the cache."""
    return {key: cache[leaf][j] for key, leaf in _STATE_LEAVES[kind].items()}


def make_paged_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                     page_size: int, num_pages: int, kv_dtype: str = "auto",
                     device=None, kv_heads: int = 0):
    """Decode cache whose KV lives in a shared page pool per layer,
    addressed through ``block_table`` (``transformer.py:262``). Only
    full-context attention stacks are paged here (windowed and recurrent
    layers keep dense per-slot state). ``kv_heads`` as ``make_cache``'s;
    int8/fp8 scales are per (page, slot, local kv head)."""
    if cache_len % page_size:
        raise ValueError(f"cache_len {cache_len} is not a multiple of "
                         f"page_size {page_size}")
    if cfg.attn_window or any(k != ATTN for k in cfg.layer_kinds):
        raise ValueError("only full-context attention-only stacks are "
                         "paged")
    hd = cfg.resolved_head_dim
    sdtype, quantized = attn_lib.kv_storage_dtype(kv_dtype, dtype)
    shape = (cfg.num_layers, num_pages, page_size,
             kv_heads or cfg.num_kv_heads, hd)
    cache = {"k_pages": torch.zeros(shape, dtype=sdtype, device=device),
             "v_pages": torch.zeros(shape, dtype=sdtype, device=device)}
    if quantized:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device)
    cache["pos"] = torch.zeros(batch, dtype=torch.int32, device=device)
    cache["block_table"] = torch.zeros((batch, cache_len // page_size),
                                       dtype=torch.int32, device=device)
    return cache


def _mlp_routed(blk, cfg: ModelConfig, x, impl: str,
                split_rows: bool = False):
    """The MLP sub-block (``transformer.py:61``): dense, or MoE with its
    dispatch and combine through ``impl``. ``split_rows``: on a rank, x
    holds its data shard's rows of the batch (a decode step's slot rows),
    not rows every data rank holds alike; the MoE routes the global batch
    either way (``moe.moe_apply``). Returns (x + its output, the MoE's
    routing for ``moe_aux``, None in a dense block)."""
    if blk.ln2 is None:        # an SSD block, or d_ff == 0: no MLP
        return x, None
    h = rmsnorm(blk.ln2.scale, x, cfg.norm_eps)
    if blk.moe is not None:
        y, routing = moe_apply(blk.moe, cfg, h, impl=impl,
                               split_rows=split_rows)
        return x + y, routing
    return x + mlp(blk.mlp, h), None


def _mlp_part(blk, cfg: ModelConfig, x, impl: str, split_rows: bool = False):
    """``_mlp_routed`` without the routing: serving drops the MoE's router
    losses, as the reference's prefill and decode do."""
    return _mlp_routed(blk, cfg, x, impl, split_rows)[0]


def _logits(model, h):
    """Logits over the whole vocabulary and the final-norm hidden state.
    A vocab-parallel rank computes its vocabulary columns (its rows of a
    tied table) and gathers the rest over the model group
    (``context.constrain_logits``)."""
    cfg = model.cfg
    h = rmsnorm(model.final_norm.scale, h, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = unembed(h, model.embed.table, tied=True)
    else:
        logits = unembed(h, model.unembed.kernel, tied=False)
    if model.vocab_world is not None:
        logits = constrain_logits(logits, model.vocab_world)
    return logits, h


def embed_inputs(model, tokens, evidence=None):
    """Token embeddings, with the evidence rows first when given
    (``transformer.py:175``): (B, Ne + L, d). Evidence of another width
    goes through ``evidence_proj``, which, as in the reference, takes the
    evidence before its cast to the activation dtype."""
    x = model.embed(tokens)
    if evidence is None:
        return x
    if model.evidence_proj is None:
        ev = evidence.to(x.dtype)
    else:
        ev = model.project_evidence(evidence).to(x.dtype)
    return torch.cat([ev, x], dim=1)


def _add_aux(acc, aux):
    """acc[k] += aux[k], for keys new to ``acc`` too."""
    for k, v in aux.items():
        acc[k] = acc[k] + v if k in acc else v


def _block_prefill(blk, cfg: ModelConfig, x, positions, impl: str,
                   lengths=None):
    """One layer over the whole sequence (``transformer.py:75-101``).
    Returns (x, the layer's cache entry: (k, v) of an attention layer or
    a recurrent layer's state, the MoE routing for ``moe_aux`` or
    None)."""
    h = rmsnorm(blk.ln1.scale, x, cfg.norm_eps)
    if blk.kind in (ATTN, LOCAL_ATTN):
        y, entry = attn_lib.attn_prefill(blk.attn, cfg, h, positions,
                                         window=window_for(cfg, blk.kind),
                                         impl=impl, lengths=lengths)
    elif blk.kind == SSM:
        y, entry = ssm_lib.ssm_prefill(blk.ssm, cfg, h, lengths=lengths)
    else:
        y, entry = rglru_lib.rglru_prefill(blk.rglru, cfg, h,
                                           lengths=lengths)
    x, routing = _mlp_routed(blk, cfg, x + y, impl)
    return x, entry, routing


def _superblock(model, blocks, x, positions, impl: str):
    """One tile of ``cfg.block_pattern`` over the whole sequence, without
    a cache (``transformer.py:220``). Returns (x, aux): each MoE layer's
    router losses and dropped share (``moe_aux``), summed over the tile's
    layers as the reference's ``_sum_aux`` sums them."""
    aux = {}
    for blk in blocks:
        x, _, routing = _block_prefill(blk, model.cfg, x, positions, impl)
        if routing is not None:
            _add_aux(aux, moe_aux(*routing))
    return x, aux


def transformer_forward(model, tokens, evidence=None, *, impl: str = "torch",
                        remat: bool = False):
    """Full-sequence forward for training and scoring
    (``transformer.py:203``): evidence rows (optional) ahead of the
    tokens, positions 0..L-1 over both, every layer's attention through
    its kind's block with no cache. Returns (logits (B, L, V), hidden
    (B, L, d) after the final norm, aux).

    ``aux`` reduces the MoE layers' values as the reference does: the sum
    over each super-block's pattern positions, the mean of that over the
    super-blocks, plus each tail layer's value (for a one-kind pattern,
    the mean over layers). ``remat`` recomputes each super-block in the
    backward pass (``torch.utils.checkpoint``, the counterpart of
    ``jax.checkpoint(superblock)``)."""
    cfg = model.cfg
    x = embed_inputs(model, tokens, evidence)
    B, L, _ = x.shape
    positions = torch.arange(L, device=x.device).expand(B, L)
    n_pat = len(cfg.block_pattern)
    n_super = cfg.num_layers // n_pat
    layers = list(model.layers)

    def run(x, blocks):
        if remat:
            return checkpoint(_superblock, model, blocks, x, positions, impl,
                              use_reentrant=False)
        return _superblock(model, blocks, x, positions, impl)

    sums = {}
    for s in range(n_super):
        x, aux = run(x, layers[s * n_pat:(s + 1) * n_pat])
        _add_aux(sums, aux)
    aux_out = {k: v / n_super for k, v in sums.items()}
    for blk in layers[n_super * n_pat:]:
        x, aux = run(x, [blk])
        _add_aux(aux_out, aux)
    logits, hidden = _logits(model, x)
    return logits, hidden, aux_out


def transformer_prefill(model, tokens, cache, evidence=None, *,
                        impl: str = "torch", lengths=None):
    """Run the prompt and seed the dense ``cache`` (``transformer.py:297``).

    ``evidence`` ((B, Ne, De), optional) is prepended to the token
    embeddings; positions run over the concatenated sequence. Without
    ``lengths`` all rows share the length Ne + L. With ``lengths`` ((B,)
    int32, counting evidence rows) rows are right-padded to a common
    bucket: last-token logits/hidden come from each row's true last
    position and ``pos`` is seeded per row. Causal masking keeps every
    real position exact under right-padding; keys past each row's length
    are masked on both impls (``attention.attn_prefill``); recurrent
    layers turn pad steps into identity steps and gather their decode
    seed at each row's length (allclose to a per-row prefill, not bit for
    bit: their chunk and scan shapes follow the padded length). A
    windowed layer's ring keeps the prompt's tail. Recurrent state is
    cast to its cache leaf's dtype (``transformer.py:486-490``). Returns
    (logits_last (B, V), hidden_last (B, d), cache)."""
    cfg = model.cfg
    x = embed_inputs(model, tokens, evidence)
    B, L, _ = x.shape
    positions = torch.arange(L, device=x.device).expand(B, L)
    if lengths is not None:
        lengths = lengths.to(torch.int32)
    slots, _ = layer_slots(cfg)
    for blk, (kind, j) in zip(model.layers, slots):
        x, entry, _ = _block_prefill(blk, cfg, x, positions, impl, lengths)
        if kind in (ATTN, LOCAL_ATTN):
            attn_lib.prefill_into_cache(cache["k"][j], cache["v"][j],
                                        *entry)
        else:
            for key, dst in _state_of(cache, kind, j).items():
                dst.copy_(entry[key].to(dst.dtype))
    if lengths is None:
        x_last = x[:, -1:]
        cache["pos"] = torch.full((B,), L, dtype=torch.int32,
                                  device=x.device)
    else:
        idx = (lengths.long() - 1)[:, None, None].expand(B, 1, x.shape[-1])
        x_last = x.gather(1, idx)
        cache["pos"] = lengths.clone()   # decode advances it in place
    logits, hidden = _logits(model, x_last)
    return logits[:, 0], hidden[:, 0], cache


def transformer_prefill_suffix(model, tokens, cache, ctx_kv, start: int, *,
                               impl: str = "torch"):
    """Continuation prefill (``transformer.py:363``): run only the prompt
    suffix whose first ``start`` positions' K/V already exist (a
    prefix-cache hit, the earlier chunks of a chunked prefill), attending
    to them as context.

    ``tokens``: (B, s) at absolute positions [start, start + s).
    ``ctx_kv``: {"k", "v": (num_layers, B, start, Hkv, hd)}. All-attention
    full-context decoders only (``Model.supports_prefix_cache``). The
    cache is seeded with the suffix K/V at row positions [0, s); callers
    keep the ``start`` offset. Returns (logits_last (B, V), hidden_last
    (B, d), cache)."""
    if not model.supports_prefix_cache:
        raise ValueError(f"{model.cfg.name}: continuation prefill needs an "
                         "all-attention full-context decoder")
    cfg = model.cfg
    x = model.embed(tokens)
    B, s, _ = x.shape
    positions = start + torch.arange(s, device=x.device).expand(B, s)
    for i, blk in enumerate(model.layers):
        h = rmsnorm(blk.ln1.scale, x, cfg.norm_eps)
        y, (k, v) = attn_lib.attn_prefill(
            blk.attn, cfg, h, positions, impl=impl,
            ctx_kv=(ctx_kv["k"][i], ctx_kv["v"][i]), q_offset=start)
        x = _mlp_part(blk, cfg, x + y, impl)
        attn_lib.prefill_into_cache(cache["k"][i], cache["v"][i], k, v)
    cache["pos"] = torch.full((B,), start + s, dtype=torch.int32,
                              device=x.device)
    logits, hidden = _logits(model, x[:, -1:])
    return logits[:, 0], hidden[:, 0], cache


def transformer_prefill_chunked(model, tokens, cache, chunk: int, *,
                                impl: str = "torch"):
    """Fixed-size chunked prefill (``transformer.py:416``): the prompt in
    ``chunk``-token pieces, each attending to the K/V of every earlier
    piece through the suffix path, so that it equals a whole-prompt
    ``transformer_prefill`` (causality hides the missing future keys in
    both). ``chunk`` 0 or >= L takes the whole-prompt path. The engine has
    its own paged form of this loop; this one pins the arithmetic.
    Returns (logits_last (B, V), hidden_last (B, d), cache)."""
    B, L = tokens.shape
    if chunk <= 0 or chunk >= L:
        return transformer_prefill(model, tokens, cache, impl=impl)
    ks, vs = [], []
    for pos in range(0, L, chunk):
        s = min(chunk, L - pos)
        piece = tokens[:, pos:pos + s]
        if pos == 0:
            logits, hidden, cache = transformer_prefill(model, piece, cache,
                                                        impl=impl)
        else:
            ctx = {"k": torch.cat(ks, dim=2), "v": torch.cat(vs, dim=2)}
            logits, hidden, cache = transformer_prefill_suffix(
                model, piece, cache, ctx, pos, impl=impl)
        # the next piece overwrites the cache's rows [0, s)
        ks.append(cache["k"][:, :, :s].clone())
        vs.append(cache["v"][:, :, :s].clone())
    cache["k"][:, :, :L] = torch.cat(ks, dim=2)
    cache["v"][:, :, :L] = torch.cat(vs, dim=2)
    cache["pos"] = torch.full((B,), L, dtype=torch.int32,
                              device=tokens.device)
    return logits, hidden, cache


def transformer_decode(model, token, cache, *, impl: str = "torch",
                       go=None):
    """One decode step (``transformer.py:493``). token: (B,) or (B, 1).
    Every row's KV is written at its ``pos``, its recurrent state updated
    in place, and every ``pos`` advances in place, idle rows included.
    ``go``: optional 0-dim bool tensor; when False, recurrent state keeps
    its value (the macro body's masked steps; the caller winds ``pos``
    back, and the KV written at ``pos`` is written again by the next
    real step). On a rank of a mesh with several data ranks the B rows
    are the rank's slot rows (its data shard of the batch), as the
    serving engine holds them. Returns (logits (B, V), hidden (B, d),
    cache)."""
    cfg = model.cfg
    if token.dim() == 1:
        token = token[:, None]
    pos = cache["pos"]
    bt = cache.get("block_table")
    x = model.embed(token)
    slots, _ = layer_slots(cfg)
    for i, (blk, (kind, j)) in enumerate(zip(model.layers, slots)):
        h = rmsnorm(blk.ln1.scale, x, cfg.norm_eps)
        if kind == SSM:
            y = ssm_lib.ssm_decode(blk.ssm, cfg, h,
                                   _state_of(cache, kind, j), go)
        elif kind == RGLRU:
            y = rglru_lib.rglru_decode(blk.rglru, cfg, h,
                                       _state_of(cache, kind, j), go)
        elif bt is not None:
            y = attn_lib.attn_decode_paged(
                blk.attn, cfg, h, cache["k_pages"][i], cache["v_pages"][i],
                pos, bt, impl=impl,
                ks=cache["k_scale"][i] if "k_scale" in cache else None,
                vs=cache["v_scale"][i] if "v_scale" in cache else None)
        else:
            y = attn_lib.attn_decode(blk.attn, cfg, h, cache["k"][j],
                                     cache["v"][j], pos,
                                     window=window_for(cfg, kind), impl=impl)
        x = _mlp_part(blk, cfg, x + y, impl, split_rows=True)
    logits, hidden = _logits(model, x)
    pos += 1        # in place: a captured decode step keeps its addresses
    return logits[:, 0], hidden[:, 0], cache


def transformer_decode_block(model, tokens, cache, valid=None, *,
                             impl: str = "torch", drop_page: int = 0):
    """Speculative block verification (``transformer.py:535``): feed S
    tokens a row at positions ``cache["pos"] + [0..S)`` and return every
    position's next-token logits. tokens: (B, S), token 0 the pending last
    token, 1..S-1 the draft; ``valid`` (B, S): invalid positions write no
    KV (a page pool's go to page ``drop_page``). ``cache["pos"]`` is not
    advanced: the caller commits the accepted prefix, and a rejected
    position's stale KV is rewritten before anything attends to it. Every
    layer's MLP part runs on all B x S tokens, so an MoE layer routes the
    invalid ones too, in (B, S) row-major order, with its dispatch and
    combine through ``impl``. All-attention full-context
    decoders only (``Model.supports_speculative``). Returns (logits
    (B, S, V), hidden (B, S, d), cache)."""
    if not model.supports_speculative:
        raise ValueError(f"{model.cfg.name}: speculative block decode needs "
                         "an all-attention full-context decoder")
    cfg = model.cfg
    pos = cache["pos"]
    bt = cache.get("block_table")
    x = model.embed(tokens)
    for i, blk in enumerate(model.layers):
        h = rmsnorm(blk.ln1.scale, x, cfg.norm_eps)
        if bt is not None:
            y = attn_lib.attn_decode_block(
                blk.attn, cfg, h, cache["k_pages"][i], cache["v_pages"][i],
                pos, block_table=bt, valid=valid,
                ks=cache["k_scale"][i] if "k_scale" in cache else None,
                vs=cache["v_scale"][i] if "v_scale" in cache else None,
                drop_page=drop_page)
        else:
            y = attn_lib.attn_decode_block(blk.attn, cfg, h, cache["k"][i],
                                           cache["v"][i], pos, valid=valid)
        x = _mlp_part(blk, cfg, x + y, impl)
    logits, hidden = _logits(model, x)
    return logits, hidden, cache
