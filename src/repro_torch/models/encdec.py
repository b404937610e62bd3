"""Encoder-decoder transformer (the SeamlessM4T-v2 backbone): the
full-sequence forward, the cache layout, prefill and decode.

Follows ``repro/models/encdec.py``, with Python loops over layers where
the reference scans over stacked layers. The speech frontend is a stub:
the encoder takes precomputed frame embeddings (``evidence``, through
``evidence_proj`` when their width is not d_model), runs bidirectional
self-attention blocks and a final norm. Each decoder layer runs causal
self-attention, cross-attention to the encoder memory (``lnx``,
``xattn``) and its MLP. The decoder's self-attention goes through
``impl`` (K2 at prefill, K3 at decode on the ``cuda`` impl); the
encoder's attention and the cross-attention run plain ``sdpa`` on every
impl, as the reference's do.

The cache is flat, as the decoder-only stacks' (batch on axis 1 of every
leaf but ``pos``, so that a cache row moves leaf by leaf):

  {"k", "v": (num_layers, B, cache_len, Hkv, hd),     self-attention ring
   "cross_k", "cross_v": (num_layers, B, Ne, Hkv, hd), encoder memory K/V
   "pos": (B,) int32}

the reference's ``self.{k,v}``, ``cross_k``, ``cross_v`` and ``pos``
(``encdec.py:153-163``). Cross K/V are computed once at prefill and held
through decode. Decode writes the ring and advances ``pos`` in place, so
that a captured decode step keeps its addresses.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Norm, embed, mlp, rmsnorm
from repro_torch.models.transformer import _logits


class EncoderBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp`` (``encdec.py:24-31``)."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, gen):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = Norm(cfg.d_model, **kw)
        self.attn = Attention(cfg, gen=gen, **kw)
        self.ln2 = Norm(cfg.d_model, **kw)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_activation, gen=gen,
                       **kw)


class DecoderBlock(EncoderBlock):
    """An encoder block's parts plus the cross-attention ``xattn`` and its
    norm ``lnx`` (``encdec.py:34-43``)."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, gen):
        super().__init__(cfg, dtype=dtype, device=device, gen=gen)
        self.lnx = Norm(cfg.d_model, dtype=dtype, device=device)
        self.xattn = Attention(cfg, dtype=dtype, device=device, gen=gen)


def _positions(B: int, L: int, device):
    return torch.arange(L, device=device).expand(B, L)


def encode(model, evidence):
    """evidence (B, Ne, De) -> memory (B, Ne, d) (``encdec.py:67-91``).
    Evidence of another width goes through ``evidence_proj`` before its
    cast to the activation dtype, as the reference's."""
    cfg = model.cfg
    x = evidence
    if model.evidence_proj is not None:
        x = model.project_evidence(x)
    x = x.to(model.embed.table.dtype)
    B, L, _ = x.shape
    positions = _positions(B, L, x.device)
    for blk in model.enc_layers:
        h = rmsnorm(blk.ln1.scale, x, cfg.norm_eps)
        y, _ = attn_lib.attn_prefill(blk.attn, cfg, h, positions,
                                     causal=False)
        x = x + y
        x = x + mlp(blk.mlp, rmsnorm(blk.ln2.scale, x, cfg.norm_eps))
    return rmsnorm(model.enc_norm.scale, x, cfg.norm_eps)


def cross_kv(model, memory):
    """Every decoder layer's cross K/V of the memory (B, Ne, d), no rope
    and no norm (``encdec.py:94-104``): (cross_k, cross_v), each
    (num_layers, B, Ne, Hkv, hd)."""
    cfg = model.cfg
    B, Ls, _ = memory.shape
    shape = (B, Ls, cfg.num_kv_heads, cfg.resolved_head_dim)
    ks = [blk.xattn.wk(memory).reshape(shape) for blk in model.dec_layers]
    vs = [blk.xattn.wv(memory).reshape(shape) for blk in model.dec_layers]
    return torch.stack(ks), torch.stack(vs)


def _dec_block(blk, cfg: ModelConfig, x, positions, ck, cv, impl: str):
    """Self-attention, cross-attention, MLP over the whole sequence
    (``encdec.py:107-117``). Returns (x, the self-attention's (k, v))."""
    h = rmsnorm(blk.ln1.scale, x, cfg.norm_eps)
    y, kv = attn_lib.attn_prefill(blk.attn, cfg, h, positions, impl=impl)
    x = x + y
    hx = rmsnorm(blk.lnx.scale, x, cfg.norm_eps)
    x = x + attn_lib.cross_attend(blk.xattn, cfg, hx, ck, cv)
    x = x + mlp(blk.mlp, rmsnorm(blk.ln2.scale, x, cfg.norm_eps))
    return x, kv


def encdec_forward(model, tokens, evidence, *, impl: str = "torch",
                   remat: bool = False):
    """Training forward (``encdec.py:120-150``): tokens (B, L) decoder
    inputs, evidence (B, Ne, De). Returns (logits (B, L, V), hidden
    (B, L, d) after the final norm, {}). ``remat`` recomputes each
    decoder layer in the backward pass, as the reference checkpoints its
    decoder body."""
    cfg = model.cfg
    ck, cv = cross_kv(model, encode(model, evidence))
    x = embed(model.embed.table, tokens)
    B, L, _ = x.shape
    positions = _positions(B, L, x.device)
    for i, blk in enumerate(model.dec_layers):
        if remat:
            x, _ = checkpoint(_dec_block, blk, cfg, x, positions, ck[i],
                              cv[i], impl, use_reentrant=False)
        else:
            x, _ = _dec_block(blk, cfg, x, positions, ck[i], cv[i], impl)
    logits, hidden = _logits(model, x)
    return logits, hidden, {}


def make_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device):
    """The zeroed cache of ``batch`` rows (``encdec.py:153-163``): the
    cross leaves hold ``num_evidence_tokens`` frames (64 without)."""
    n, hd = cfg.num_layers, cfg.resolved_head_dim
    src = cfg.num_evidence_tokens or 64
    cache = {}
    for name, S in (("k", cache_len), ("v", cache_len), ("cross_k", src),
                    ("cross_v", src)):
        cache[name] = torch.zeros((n, batch, S, cfg.num_kv_heads, hd),
                                  dtype=dtype, device=device)
    cache["pos"] = torch.zeros(batch, dtype=torch.int32, device=device)
    return cache


def encdec_prefill(model, tokens, cache, evidence, *, impl: str = "torch"):
    """Encode the evidence, seed the cross K/V and run the prompt through
    the decoder, seeding its rings (``encdec.py:166-197``). All rows share
    the prompt length L. Returns (logits_last (B, V), hidden_last (B, d),
    cache)."""
    cfg = model.cfg
    ck, cv = cross_kv(model, encode(model, evidence))
    x = embed(model.embed.table, tokens)
    B, L, _ = x.shape
    positions = _positions(B, L, x.device)
    for i, blk in enumerate(model.dec_layers):
        x, (k, v) = _dec_block(blk, cfg, x, positions, ck[i], cv[i], impl)
        attn_lib.prefill_into_cache(cache["k"][i], cache["v"][i], k, v)
    cache["cross_k"].copy_(ck)
    cache["cross_v"].copy_(cv)
    cache["pos"] = torch.full((B,), L, dtype=torch.int32, device=x.device)
    logits, hidden = _logits(model, x[:, -1:])
    return logits[:, 0], hidden[:, 0], cache


def encdec_decode(model, token, cache, *, impl: str = "torch"):
    """One decode step (``encdec.py:200-236``). token: (B,) or (B, 1).
    Every row's self K/V is written at its ``pos`` into the ring, the
    cross K/V are read as they are, and every ``pos`` advances, all in
    place. Returns (logits (B, V), hidden (B, d), cache)."""
    cfg = model.cfg
    if token.dim() == 1:
        token = token[:, None]
    pos = cache["pos"]
    x = embed(model.embed.table, token)
    for i, blk in enumerate(model.dec_layers):
        h = rmsnorm(blk.ln1.scale, x, cfg.norm_eps)
        x = x + attn_lib.attn_decode(blk.attn, cfg, h, cache["k"][i],
                                     cache["v"][i], pos, impl=impl)
        hx = rmsnorm(blk.lnx.scale, x, cfg.norm_eps)
        x = x + attn_lib.cross_attend(blk.xattn, cfg, hx,
                                      cache["cross_k"][i],
                                      cache["cross_v"][i])
        x = x + mlp(blk.mlp, rmsnorm(blk.ln2.scale, x, cfg.norm_eps))
    logits, hidden = _logits(model, x)
    pos += 1        # in place: a captured decode step keeps its addresses
    return logits[:, 0], hidden[:, 0], cache
