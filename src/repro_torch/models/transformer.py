"""Decoder-only attention stacks: the full-sequence forward, cache
layouts, prefill and decode.

Follows ``repro/models/transformer.py`` for attention-only stacks, with a
Python loop over layers where the reference scans over stacked
super-blocks. Caches stack the per-layer tensors on a leading layer axis:

  dense: {"k", "v": (num_layers, B, S, Hkv, hd), "pos": (B,) int32}
  paged: {"k_pages", "v_pages": (num_layers, P, ps, Hkv, hd),
          ["k_scale", "v_scale": (num_layers, P, ps, Hkv) fp32,]
          "pos": (B,) int32, "block_table": (B, cache_len // ps) int32}

so ``cache["k"][l]`` is layer l's (B, S, Hkv, hd) ring and
``cache["k_pages"][l]`` its (P, ps, Hkv, hd) pool. Prefill and decode
update the cache tensors in place and return the same dict.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import dense, embed, mlp, rmsnorm, unembed
from repro_torch.models.moe import moe_apply, moe_aux


def _ring_len(cfg: ModelConfig, cache_len: int) -> int:
    return cache_len if cfg.attn_window == 0 else \
        min(cache_len, cfg.attn_window)


def make_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device):
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, _ring_len(cfg, cache_len),
             cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros(batch, dtype=torch.int32, device=device)}


def make_paged_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                     page_size: int, num_pages: int, kv_dtype: str = "auto",
                     device=None):
    """Decode cache whose KV lives in a shared page pool per layer,
    addressed through ``block_table`` (``transformer.py:262``). Windowed
    layers are not paged (their ring is already bounded)."""
    if cache_len % page_size:
        raise ValueError(f"cache_len {cache_len} is not a multiple of "
                         f"page_size {page_size}")
    if cfg.attn_window:
        raise ValueError("windowed attention layers are not paged")
    hd = cfg.resolved_head_dim
    sdtype, quantized = attn_lib.kv_storage_dtype(kv_dtype, dtype)
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, hd)
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


def _mlp_routed(blk, cfg: ModelConfig, x, impl: str):
    """The MLP sub-block (``transformer.py:61``): dense, or MoE with its
    dispatch and combine through ``impl``. Returns (x + its output, the
    MoE's routing for ``moe_aux``, None in a dense block)."""
    if blk.ln2 is None:                 # d_ff == 0: attention-only block
        return x, None
    h = rmsnorm(blk.ln2.scale, x, cfg.norm_eps)
    if blk.moe is not None:
        y, routing = moe_apply(blk.moe, cfg, h, impl=impl)
        return x + y, routing
    return x + mlp(blk.mlp, h), None


def _mlp_part(blk, cfg: ModelConfig, x, impl: str):
    """``_mlp_routed`` without the routing: serving drops the MoE's router
    losses, as the reference's prefill and decode do."""
    return _mlp_routed(blk, cfg, x, impl)[0]


def _logits(model, h):
    cfg = model.cfg
    h = rmsnorm(model.final_norm.scale, h, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(h, model.embed.table, tied=True), h
    return unembed(h, model.unembed.kernel, tied=False), h


def embed_inputs(model, tokens, evidence=None):
    """Token embeddings, with the evidence rows first when given
    (``transformer.py:175``): (B, Ne + L, d). Evidence of another width
    goes through ``evidence_proj``, which, as in the reference, takes the
    evidence before its cast to the activation dtype."""
    x = embed(model.embed.table, tokens)
    if evidence is None:
        return x
    if model.evidence_proj is None:
        ev = evidence.to(x.dtype)
    else:
        kernel = model.evidence_proj.kernel
        dt = torch.promote_types(evidence.dtype, kernel.dtype)
        ev = dense(kernel.to(dt), evidence.to(dt)).to(x.dtype)
    return torch.cat([ev, x], dim=1)


def _add_aux(acc, aux):
    """acc[k] += aux[k], for keys new to ``acc`` too."""
    for k, v in aux.items():
        acc[k] = acc[k] + v if k in acc else v


def _superblock(model, blocks, x, positions, impl: str):
    """One tile of ``cfg.block_pattern`` over the whole sequence, without
    a cache (``transformer.py:220``). Returns (x, aux): each MoE layer's
    router losses and dropped share (``moe_aux``), summed over the tile's
    layers as the reference's ``_sum_aux`` sums them."""
    cfg = model.cfg
    aux = {}
    for blk in blocks:
        h = rmsnorm(blk.ln1.scale, x, cfg.norm_eps)
        y, _ = attn_lib.attn_prefill(blk.attn, cfg, h, positions,
                                     window=cfg.attn_window, impl=impl)
        x, routing = _mlp_routed(blk, cfg, x + y, impl)
        if routing is not None:
            _add_aux(aux, moe_aux(*routing))
    return x, aux


def transformer_forward(model, tokens, evidence=None, *, impl: str = "torch",
                        remat: bool = False):
    """Full-sequence forward for training and scoring
    (``transformer.py:203``): evidence rows (optional) ahead of the
    tokens, positions 0..L-1 over both, every layer's attention through
    ``attn_prefill`` with no cache. Returns (logits (B, L, V), hidden
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
    are masked on both impls (``attention.attn_prefill``). Returns
    (logits_last (B, V), hidden_last (B, d), cache)."""
    cfg = model.cfg
    x = embed_inputs(model, tokens, evidence)
    B, L, _ = x.shape
    positions = torch.arange(L, device=x.device).expand(B, L)
    if lengths is not None:
        lengths = lengths.to(torch.int32)
    for i, blk in enumerate(model.layers):
        h = rmsnorm(blk.ln1.scale, x, cfg.norm_eps)
        y, (k, v) = attn_lib.attn_prefill(blk.attn, cfg, h, positions,
                                          window=cfg.attn_window, impl=impl,
                                          lengths=lengths)
        x = _mlp_part(blk, cfg, x + y, impl)
        attn_lib.prefill_into_cache(cache["k"][i], cache["v"][i], k, v)
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
    x = embed(model.embed.table, tokens)
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


def transformer_decode(model, token, cache, *, impl: str = "torch"):
    """One decode step (``transformer.py:493``). token: (B,) or (B, 1).
    Every row's KV is written at its ``pos`` and every ``pos`` advances in
    place, idle rows included. Returns (logits (B, V), hidden (B, d),
    cache)."""
    cfg = model.cfg
    if token.dim() == 1:
        token = token[:, None]
    pos = cache["pos"]
    bt = cache.get("block_table")
    x = embed(model.embed.table, token)
    for i, blk in enumerate(model.layers):
        h = rmsnorm(blk.ln1.scale, x, cfg.norm_eps)
        if bt is not None:
            y = attn_lib.attn_decode_paged(
                blk.attn, cfg, h, cache["k_pages"][i], cache["v_pages"][i],
                pos, bt, impl=impl,
                ks=cache["k_scale"][i] if "k_scale" in cache else None,
                vs=cache["v_scale"][i] if "v_scale" in cache else None)
        else:
            y = attn_lib.attn_decode(blk.attn, cfg, h, cache["k"][i],
                                     cache["v"][i], pos,
                                     window=cfg.attn_window, impl=impl)
        x = _mlp_part(blk, cfg, x + y, impl)
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
    x = embed(model.embed.table, tokens)
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
