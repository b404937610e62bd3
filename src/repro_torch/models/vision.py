"""ViT vision tower of the image-prefill serving path.

Follows ``repro/models/vision.py``: images arrive as (B, H, W, C) float
tensors; the tower patchifies them in row-major grid order, adds a
learned position table, runs ``cfg.vision.num_layers`` bidirectional
pre-norm blocks (multi-head attention with an fp32 softmax, then a gelu
MLP), and projects to the LM's evidence dim. The output,
(B, num_evidence_tokens, evidence_dim), is evidence exactly like the
precomputed kind.

The reference computes this attention with plain einsums outside any
Pallas kernel, and the port keeps plain matrix products: the encode runs
once per distinct image at submit time, memoised by the engine.

On a rank of a model axis (``Model(..., world=)``) the tower holds the
rule table's blocks: ``wq``/``wk``/``wv`` the rank's heads and ``wo`` their
rows (summed over the model group), ``patch_proj``, ``w_in`` and
``w_out`` output columns gathered whole, ``out_proj`` rows of the
contracting dim (summed); every rank of a model group encodes the same
evidence.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.layers import MLP, Dense, Norm, _normal, mlp, \
    rmsnorm


def patchify(images, patch: int):
    """(B, H, W, C) -> (B, n_patches, patch*patch*C), row-major grid."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, patch * patch * C)


class VisionBlock(nn.Module):
    def __init__(self, d: int, d_ff: int, *, dtype, device, gen):
        super().__init__()
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.ln1 = Norm(d, dtype=dtype, device=device)
        self.wq = Dense(d, d, **kw)
        self.wk = Dense(d, d, **kw)
        self.wv = Dense(d, d, **kw)
        self.wo = Dense(d, d, **kw)
        self.ln2 = Norm(d, dtype=dtype, device=device)
        self.mlp = MLP(d, d_ff, "gelu", **kw)


class VisionTower(nn.Module):
    """Tower weights under the reference's names (``patch_proj``,
    ``pos_emb``, ``blocks.<i>``, ``final_norm``, ``out_proj``)."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, gen):
        super().__init__()
        v = cfg.vision
        if v.n_patches != cfg.num_evidence_tokens:
            raise ValueError(f"vision tower yields {v.n_patches} patches but "
                             f"the LM expects {cfg.num_evidence_tokens} "
                             "evidence tokens")
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.patch_proj = Dense(v.patch * v.patch * v.channels, v.d_model,
                                **kw)
        self.pos_emb = _normal((v.n_patches, v.d_model), 0.02, dtype, device,
                               gen)
        self.blocks = nn.ModuleList(VisionBlock(v.d_model, v.d_ff, **kw)
                                    for _ in range(v.num_layers))
        self.final_norm = Norm(v.d_model, dtype=dtype, device=device)
        self.out_proj = Dense(v.d_model, cfg.evidence_dim or cfg.d_model,
                              **kw)


def _mha(p: VisionBlock, num_heads: int, x):
    """Bidirectional multi-head attention: every patch sees every patch.
    A rank runs the heads its ``wq`` columns hold."""
    B, N, d = x.shape
    hd = d // num_heads
    heads = p.wq.kernel.shape[1] // hd
    q = p.wq(x).reshape(B, N, heads, hd)
    k = p.wk(x).reshape(B, N, heads, hd)
    v = p.wv(x).reshape(B, N, heads, hd)
    att = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    att = torch.softmax(att * hd ** -0.5, dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, N, heads * hd)
    return p.wo(o)


def _rows_of(dense: Dense, x):
    """The columns of a whole input that a row-parallel rank's kernel
    rows take; the whole input elsewhere."""
    if dense.reduce_world is None:
        return x
    k = dense.kernel.shape[0]
    return x.narrow(-1, dense.reduce_world.coords[1] * k, k)


def vision_encode(tower: VisionTower, cfg: ModelConfig, images):
    """(B, H, W, C) float images -> (B, n_patches, evidence_dim)."""
    v = cfg.vision
    x = patchify(images, v.patch)
    x = tower.patch_proj(x) + tower.pos_emb[None]
    for blk in tower.blocks:
        x = x + _mha(blk, v.num_heads, rmsnorm(blk.ln1.scale, x,
                                               cfg.norm_eps))
        x = x + mlp(blk.mlp, rmsnorm(blk.ln2.scale, x, cfg.norm_eps))
    x = rmsnorm(tower.final_norm.scale, x, cfg.norm_eps)
    return tower.out_proj(_rows_of(tower.out_proj, x))
