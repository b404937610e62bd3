"""Model facade of the port: parameters as ``nn.Module``s plus the serving
API the engine calls (``repro/models/model.py:94-223``).

Parameter names mirror the reference's param tree: ``embed.table``,
``layers.<i>.ln1.scale``, ``layers.<i>.attn.wq.kernel``,
``layers.<i>.mlp.w_gate.kernel``, ``final_norm.scale`` and, untied,
``unembed.kernel`` — ``convert.params_from_jax`` produces exactly these
keys. This slice serves decoder-only attention stacks; other families
raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.config import ATTN, ModelConfig
from repro_torch.models import transformer as tf_lib
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Norm, Dense, _normal

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = [
        ("encoder-decoder", cfg.is_encoder_decoder),
        ("mixture-of-experts", cfg.moe is not None),
        ("SSM / RG-LRU / local-attention blocks",
         any(k != ATTN for k in cfg.layer_kinds)),
        ("vision tower / evidence tokens",
         cfg.vision is not None or cfg.num_evidence_tokens > 0),
        (f"{cfg.mlp_activation} MLPs", cfg.mlp_activation != "swiglu"),
    ]
    for what, present in unsupported:
        if present:
            raise NotImplementedError(
                f"{cfg.name}: {what} are not ported yet; this slice serves "
                "decoder-only attention stacks")


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, *, dtype, device, gen):
        super().__init__()
        self.table = _normal((vocab, d), d ** -0.5, dtype, device, gen)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device, gen):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = Norm(cfg.d_model, **kw)
        self.attn = Attention(cfg, gen=gen, **kw)
        self.ln2 = Norm(cfg.d_model, **kw) if cfg.d_ff > 0 else None
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gen=gen, **kw) \
            if cfg.d_ff > 0 else None


class Model(nn.Module):
    """Decoder-only attention LM with seeded random weights (load real or
    reference weights with ``load_state_dict``)."""

    def __init__(self, cfg: ModelConfig, param_dtype=None, *, device=None,
                 seed: int = 0):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.param_dtype = param_dtype or _DTYPES[cfg.dtype]
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        kw = dict(dtype=self.param_dtype, device=self.device, gen=gen)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.layers = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg.d_model, dtype=self.param_dtype,
                               device=self.device)
        if not cfg.tie_embeddings:
            self.unembed = Dense(cfg.d_model, cfg.vocab_size, **kw)

    # -- serving ---------------------------------------------------------
    def make_cache(self, batch: int, cache_len: int, dtype=None):
        return tf_lib.make_cache(self.cfg, batch, cache_len,
                                 dtype or self.param_dtype, self.device)

    def make_paged_cache(self, batch: int, cache_len: int, dtype=None, *,
                         page_size: int, num_pages: int,
                         kv_dtype: str = "auto"):
        return tf_lib.make_paged_cache(self.cfg, batch, cache_len,
                                       dtype or self.param_dtype, page_size,
                                       num_pages, kv_dtype=kv_dtype,
                                       device=self.device)

    def prefill(self, tokens, cache, *, impl: str = "torch", lengths=None):
        """``lengths``: optional (B,) int32 true lengths for
        length-bucketed batched prefill over right-padded rows."""
        return tf_lib.transformer_prefill(self, tokens, cache, impl=impl,
                                          lengths=lengths)

    def decode_step(self, token, cache, *, impl: str = "torch"):
        return tf_lib.transformer_decode(self, token, cache, impl=impl)

    # -- capability flags the engine reads ---------------------------------
    @property
    def has_pageable_layers(self) -> bool:
        """Full-context attention layers whose KV the page pool can hold."""
        return self.cfg.attn_window == 0

    @property
    def supports_bucketed_prefill(self) -> bool:
        """Right-padded bucketed prefill is exact for attention-only
        stacks (causality hides the pads from real positions)."""
        return True


def build_model(cfg: ModelConfig, param_dtype=None, *, device=None,
                seed: int = 0) -> Model:
    return Model(cfg, param_dtype, device=device, seed=seed)
