"""Model facade of the port: parameters as ``nn.Module``s plus the
full-sequence forward and the serving API the engine calls
(``repro/models/model.py:38-223``).

Parameter names mirror the reference's param tree: ``embed.table``,
``layers.<i>.ln1.scale``, ``layers.<i>.attn.wq.kernel`` (an attention
layer), ``layers.<i>.ssm.in_proj.kernel`` (an SSD layer),
``layers.<i>.rglru.w_x.kernel`` (an RG-LRU layer),
``layers.<i>.mlp.w_gate.kernel`` (or, in MoE configs,
``layers.<i>.moe.router.kernel`` and ``layers.<i>.moe.w_gate``),
``final_norm.scale``, untied ``unembed.kernel`` and, for the vlm family,
``evidence_proj.kernel`` and the vision tower's ``vision.*``. An
encoder-decoder stack (``models/encdec.py``) has ``enc_layers.<i>.*``
(``ln1``, ``attn``, ``ln2``, ``mlp``), ``dec_layers.<i>.*`` (those and
the cross-attention ``xattn`` with its norm ``lnx``) and ``enc_norm``
in place of ``layers``. ``convert.params_from_jax`` produces exactly
these keys. The port runs the full-sequence forward (training,
rescoring) and serves decoder-only stacks of attention (full, windowed,
local), SSD and RG-LRU blocks with dense or MoE MLPs, with evidence
tokens and a vision tower in the vlm family, and encoder-decoder stacks
whose encoder takes the evidence (the audio family); the paged cache,
continuation prefill and speculative blocks are decoder-only, as in the
reference. Parameters are made with ``requires_grad`` off;
``training.train_loop.train`` turns it on.

Built for a rank of a serving mesh (``world``, a
``distributed.context.RankWorld``), a model draws every whole tensor
from the seeded generator in the one-device order and keeps the rank's
block under the rule table's serving specs as the port cuts them
(``sharding.rank_specs``), a part (the embedding, a layer, the
vision tower) at a time, so that a rank never holds the whole model:
its query and kv heads, MLP columns and vocabulary rows on the model
axis, and an MoE layer's experts on the data axis and their hidden
width on the model axis where the table cuts them, so that the ranks'
weights are slices of the one-device model's, bit for bit. Row-parallel
``wo``, ``w_down`` and the tower's ``out_proj`` then sum over the model
group, the tower's other column cuts gather, an MoE layer sums its
partial outputs over the ranks that share them, the embedding is
vocab-parallel and the logits are gathered. Decoder-only stacks are
cut so, attention-only ones with dense or MoE MLPs, with the vlm
family's evidence and tower, and recurrent and hybrid ones: an SSD
block keeps its heads (the one group's B and C channels whole on every
model rank) and sums its gated norm's squares and its ``out_proj`` over
the model group; an RG-LRU block keeps its block of the width, gathers
its conv output over the model group for the gates and sums
``out_proj``; a gelu MLP's ``w_out`` is row-parallel; one kv head is
held whole beside the rank's query heads. An encoder-decoder raises
``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.config import ATTN, LOCAL_ATTN, RGLRU, SSM, ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Dense, Norm, _normal, dense, embed
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RGLRU as RGLRUBlock
from repro_torch.models.ssm import SSM as SSMBlock
from repro_torch.models.vision import VisionTower, vision_encode

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = [
        ("evidence tokens / vision towers of a decoder-only stack outside "
         "the vlm family",
         cfg.family != "vlm" and not cfg.is_encoder_decoder and
         (cfg.vision is not None or cfg.num_evidence_tokens > 0)),
        (f"{cfg.mlp_activation} MoE experts",
         cfg.moe is not None and cfg.mlp_activation != "swiglu"),
    ]
    for what, present in unsupported:
        if present:
            raise NotImplementedError(
                f"{cfg.name}: {what} are not ported yet; the port serves "
                "decoder-only stacks of attention, SSD and RG-LRU blocks "
                "with dense or MoE MLPs (with evidence in the vlm family) "
                "and encoder-decoder stacks")


def check_rank_supported(cfg: ModelConfig, world) -> None:
    """The families a rank of a serving mesh cannot hold yet, each with
    its step of ROADMAP.md Queue 1 item 5, and the model axis's split
    (``sharding.check_model_split``)."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder stack over ranks is not ported "
            "yet (ROADMAP.md Queue 1 item 5, step 4, encoder-decoder over "
            "ranks); a rank holds decoder-only stacks of attention, SSD and "
            "RG-LRU blocks, with dense or MoE MLPs")
    shd.check_model_split(cfg, world)


class Embedding(nn.Module):
    """The (V, d) table, or a vocab-parallel rank's rows [start, start +
    V / model) of it with its model group ``world``."""

    def __init__(self, vocab: int, d: int, *, dtype, device, gen):
        super().__init__()
        self.table = _normal((vocab, d), d ** -0.5, dtype, device, gen)
        self.start = 0
        self.world = None

    def forward(self, tokens):
        return embed(self.table, tokens, self.start, self.world)


class Block(nn.Module):
    """One layer of kind ``kind``: ``attn`` (ATTN, LOCAL_ATTN), ``ssm`` or
    ``rglru`` under the reference's names (``transformer.py:40-58``),
    and the MLP where the kind has one."""

    def __init__(self, cfg: ModelConfig, kind: str, *, dtype, device, gen):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.kind = kind
        self.ln1 = Norm(cfg.d_model, **kw)
        if kind in (ATTN, LOCAL_ATTN):
            self.attn = Attention(cfg, gen=gen, **kw)
        elif kind == SSM:
            self.ssm = SSMBlock(cfg, gen=gen, **kw)
        elif kind == RGLRU:
            self.rglru = RGLRUBlock(cfg, gen=gen, **kw)
        else:
            raise ValueError(f"unknown block kind {kind!r}")
        has_mlp = tf_lib.has_mlp(cfg, kind)
        self.ln2 = Norm(cfg.d_model, **kw) if has_mlp else None
        self.moe = MoE(cfg, gen=gen, **kw) if cfg.moe is not None else None
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_activation, gen=gen,
                       **kw) if has_mlp and self.moe is None else None


class Model(nn.Module):
    """Decoder-only or encoder-decoder LM with seeded random weights (load
    real or reference weights with ``load_state_dict``), with the
    evidence projection and vision tower of a vlm config."""

    def __init__(self, cfg: ModelConfig, param_dtype=None, *, device=None,
                 seed: int = 0, world=None):
        super().__init__()
        _check_supported(cfg)
        if world is not None:
            check_rank_supported(cfg, world)
        self.cfg = cfg
        self.param_dtype = param_dtype or _DTYPES[cfg.dtype]
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        kw = dict(dtype=self.param_dtype, device=self.device, gen=gen)
        # the rank world the weights are cut for, the model group the
        # logits gather over (vocab-parallel) and the kv heads a layer
        # caches; a rank cuts each part as soon as it is drawn, so that it
        # never holds the whole model
        self.world = world
        self.vocab_world = None
        self.kv_heads = cfg.num_kv_heads
        self._whole = None if world is None else {}
        keep = self._keeper(world)
        self.embed = keep(Embedding(cfg.vocab_size, cfg.d_model, **kw),
                          "embed")
        if cfg.is_encoder_decoder:
            self.enc_layers = nn.ModuleList(
                keep(encdec_lib.EncoderBlock(cfg, **kw), f"enc_layers.{i}")
                for i in range(cfg.num_encoder_layers))
            self.dec_layers = nn.ModuleList(
                keep(encdec_lib.DecoderBlock(cfg, **kw), f"dec_layers.{i}")
                for i in range(cfg.num_layers))
            self.enc_norm = Norm(cfg.d_model, dtype=self.param_dtype,
                                 device=self.device)
        else:
            self.layers = nn.ModuleList(
                keep(Block(cfg, kind, **kw), f"layers.{i}")
                for i, kind in enumerate(cfg.layer_kinds))
        self.final_norm = Norm(cfg.d_model, dtype=self.param_dtype,
                               device=self.device)
        if not cfg.tie_embeddings:
            self.unembed = keep(Dense(cfg.d_model, cfg.vocab_size, **kw),
                                "unembed")
        # transformer.py:162-167, encdec.py:61-62
        self.evidence_proj = keep(
            Dense(cfg.evidence_dim, cfg.d_model, **kw), "evidence_proj") \
            if cfg.num_evidence_tokens and cfg.evidence_dim != cfg.d_model \
            else None
        self.vision = keep(VisionTower(cfg, **kw), "vision") \
            if cfg.vision is not None else None
        if world is not None:
            self._whole.update((k, tuple(p.shape))
                               for k, p in self.named_parameters()
                               if k not in self._whole)
            self._wire_rank(world)

    def param_shapes(self):
        """Every parameter's whole shape (a rank's model: before its cut),
        by state-dict name: what the rule table specs."""
        return self._whole or {k: tuple(p.shape)
                               for k, p in self.named_parameters()}

    def _keeper(self, world):
        """What the constructor passes each freshly drawn part through:
        without a world the part itself; for a rank, the part with every
        parameter cut to the rank's block under the serving specs as the
        port cuts them (``sharding.rank_specs``) into new storage, so the
        whole tensors
        are freed before the next part is drawn. The draws keep the
        one-device order, so the blocks are the seeded one-device
        model's, bit for bit."""
        if world is None:
            return lambda part, prefix: part
        at = shd.rank_coords(world)

        def keep(part, prefix):
            shapes = {f"{prefix}.{k}": tuple(p.shape)
                      for k, p in part.named_parameters()}
            self._whole.update(shapes)
            cuts = shd.rank_specs(self.cfg, shapes, world)
            for k, p in part.named_parameters():
                block = shd.local_shard(p.data, cuts[f"{prefix}.{k}"],
                                        world, at)
                p.data = torch.empty(block.shape, dtype=block.dtype,
                                     device=block.device).copy_(block)
            return part
        return keep

    def _wire_rank(self, world) -> None:
        """Wire the model group into the cut model: row-parallel
        projections (``wo``, ``w_down``, a non-gated MLP's ``w_out``, the
        SSD and RG-LRU blocks' ``out_proj``, the tower's ``wo`` and
        ``out_proj``) sum over it, the vision tower's column cuts whose
        outputs the next op needs whole (``patch_proj``, the gelu MLP's
        ``w_in`` and ``w_out``; its ``wq``/``wk``/``wv`` keep the rank's
        heads) and ``evidence_proj`` gather over it, the embedding is
        vocab-parallel and the logits gather. An MoE layer takes the
        world: it sums its experts' partial outputs itself
        (``moe.moe_apply``); so do the SSD blocks (the gated norm's sum
        of squares) and the RG-LRU blocks (the gather of the conv output
        the gates read) at a model axis above 1. A layer caches its kv
        heads: ``Hkv / model``, or the one kv head every model rank holds
        whole."""
        specs = shd.rank_specs(self.cfg, self._whole, world)
        model_axis = shd.ShardingRules().model_axis
        for name, mod in self.named_modules():
            if isinstance(mod, MoE) or (
                    isinstance(mod, (SSMBlock, RGLRUBlock)) and
                    world.model > 1):
                mod.world = world
            if not isinstance(mod, Dense):
                continue
            spec = specs[f"{name}.kernel"]
            if spec[0] == model_axis:
                mod.reduce_world = world           # row-parallel
            elif spec[1] == model_axis and (
                    name == "evidence_proj" or
                    (name.startswith("vision.") and
                     name.rsplit(".", 1)[-1] not in ("wq", "wk", "wv"))):
                mod.gather_world = world           # gathered columns
        if specs["embed.table"][0] == model_axis:
            self.embed.start = world.coords[1] * self.embed.table.shape[0]
            self.embed.world = self.vocab_world = world
        if world.model > 1 and self.cfg.num_kv_heads % world.model == 0:
            self.kv_heads = self.cfg.num_kv_heads // world.model

    # -- full-sequence forward (training / scoring) ----------------------
    def forward(self, tokens, evidence=None, *, impl: str = "torch",
                remat: bool = False):
        """Every position's logits (``repro/models/model.py:38``): tokens
        (B, L), optional evidence (B, Ne, De) ahead of them. Returns
        (logits (B, Ne + L, V), hidden (B, Ne + L, d), aux), ``aux`` the
        MoE layers' ``moe_lb_loss``, ``moe_z_loss`` and ``moe_drop_frac``
        (empty for a dense model). An encoder-decoder takes its evidence
        (required) into the encoder and returns (logits (B, L, V), hidden
        (B, L, d), {}). ``remat`` recomputes each layer in the backward
        pass."""
        if self.cfg.is_encoder_decoder:
            if evidence is None:
                raise ValueError(f"{self.cfg.name}: an encoder-decoder "
                                 "needs encoder inputs (evidence)")
            return encdec_lib.encdec_forward(self, tokens, evidence,
                                             impl=impl, remat=remat)
        return tf_lib.transformer_forward(self, tokens, evidence, impl=impl,
                                          remat=remat)

    # -- serving ---------------------------------------------------------
    def make_cache(self, batch: int, cache_len: int, dtype=None):
        if self.cfg.is_encoder_decoder:
            return encdec_lib.make_cache(self.cfg, batch, cache_len,
                                         dtype or self.param_dtype,
                                         self.device)
        return tf_lib.make_cache(self.cfg, batch, cache_len,
                                 dtype or self.param_dtype, self.device,
                                 kv_heads=self.kv_heads,
                                 split=self.world.model if self.world
                                 is not None else 1)

    def make_paged_cache(self, batch: int, cache_len: int, dtype=None, *,
                         page_size: int, num_pages: int,
                         kv_dtype: str = "auto"):
        if self.cfg.is_encoder_decoder:
            # repro/models/model.py:65-67: the cross K/V are per-request
            # constants, not pages
            raise NotImplementedError(
                "paged KV cache is decoder-only for now")
        return tf_lib.make_paged_cache(self.cfg, batch, cache_len,
                                       dtype or self.param_dtype, page_size,
                                       num_pages, kv_dtype=kv_dtype,
                                       device=self.device,
                                       kv_heads=self.kv_heads)

    def prefill(self, tokens, cache, evidence=None, *, impl: str = "torch",
                lengths=None):
        """``evidence``: optional (B, Ne, De) rows prefilled ahead of the
        tokens. ``lengths``: optional (B,) int32 true lengths, evidence
        rows included, for length-bucketed batched prefill over
        right-padded rows. An encoder-decoder encodes the evidence
        (required) instead and takes no ``lengths``."""
        if self.cfg.is_encoder_decoder:
            if evidence is None or lengths is not None:
                raise ValueError(f"{self.cfg.name}: encoder-decoder prefill "
                                 "takes evidence and no bucketed lengths")
            return encdec_lib.encdec_prefill(self, tokens, cache, evidence,
                                             impl=impl)
        return tf_lib.transformer_prefill(self, tokens, cache, evidence,
                                          impl=impl, lengths=lengths)

    def prefill_suffix(self, tokens, cache, ctx_kv, start: int, *,
                       impl: str = "torch"):
        """Continuation prefill for prefix-cache hits
        (``repro/models/model.py:164``): only the suffix ``tokens`` (at
        positions start..) run, attending to ``ctx_kv``, the cached K/V of
        positions [0, start): {"k", "v": (num_layers, B, start, Hkv, hd)}.
        Needs ``supports_prefix_cache``."""
        self._decoder_only("continuation prefill")
        return tf_lib.transformer_prefill_suffix(self, tokens, cache, ctx_kv,
                                                 start, impl=impl)

    def prefill_chunked(self, tokens, cache, chunk: int, *,
                        impl: str = "torch"):
        """The prompt in ``chunk``-token pieces through the suffix path,
        equal to the whole-prompt ``prefill``; whole prefill when
        ``chunk`` is 0 or covers the prompt."""
        self._decoder_only("chunked prefill")
        return tf_lib.transformer_prefill_chunked(self, tokens, cache, chunk,
                                                  impl=impl)

    def project_evidence(self, evidence):
        """``evidence_proj`` of (.., Ne, De) evidence in the promotion of
        its dtype and the kernel's (``transformer.py:175``); a rank's
        column block is gathered over the model group."""
        proj = self.evidence_proj
        dt = torch.promote_types(evidence.dtype, proj.kernel.dtype)
        out = dense(proj.kernel.to(dt), evidence.to(dt))
        if proj.gather_world is not None:
            out = proj.gather_world.all_gather_model(out, dim=-1)
        return out

    def encode_image(self, images):
        """Vision-tower encode (``repro/models/model.py:144``): images
        (B, H, W, C) float -> evidence (B, num_evidence_tokens,
        evidence_dim)."""
        if self.vision is None:
            raise ValueError(f"{self.cfg.name} has no vision tower "
                             "(cfg.vision is None)")
        images = images.to(self.vision.patch_proj.kernel.dtype)
        return vision_encode(self.vision, self.cfg, images)

    def decode_step(self, token, cache, *, impl: str = "torch", go=None):
        """One token a row. ``go``: optional 0-dim bool tensor; when False
        the recurrent layers keep their state (a masked macro step); an
        encoder-decoder has none."""
        if self.cfg.is_encoder_decoder:
            return encdec_lib.encdec_decode(self, token, cache, impl=impl)
        return tf_lib.transformer_decode(self, token, cache, impl=impl,
                                         go=go)

    def decode_block(self, tokens, cache, valid=None, *,
                     impl: str = "torch", drop_page: int = 0):
        """Speculative block verification (``repro/models/model.py:205``):
        tokens (B, S) at positions ``cache["pos"] + [0..S)``; returns
        (logits (B, S, V), hidden (B, S, d), cache) without advancing
        ``cache["pos"]``. ``valid`` (B, S): positions that write KV; a page
        pool takes the others' writes on page ``drop_page``. Needs
        ``supports_speculative``."""
        self._decoder_only("speculative block decode")
        return tf_lib.transformer_decode_block(self, tokens, cache, valid,
                                               impl=impl, drop_page=drop_page)

    def _decoder_only(self, what: str) -> None:
        if self.cfg.is_encoder_decoder:
            raise ValueError(f"{self.cfg.name}: {what} is decoder-only "
                             "(an encoder-decoder prefills whole prompts)")

    # -- capability flags the engine reads (repro/models/model.py:95-220)
    @property
    def state_kind(self) -> str:
        """What a serving slot owns: ``"kv"`` (every layer caches attention
        KV, possibly windowed), ``"recurrent"`` (every layer carries
        fixed-size recurrent state: SSD state and conv tail, RG-LRU h and
        conv tail) or ``"hybrid"`` (both). Recurrent and hybrid slots keep
        their prompt state in the engine's ``StateArena``."""
        if self.cfg.is_encoder_decoder:
            return "kv"
        kinds = set(self.cfg.layer_kinds)
        attn = bool(kinds & {ATTN, LOCAL_ATTN})
        recurrent = bool(kinds - {ATTN, LOCAL_ATTN})
        if attn and recurrent:
            return "hybrid"
        return "recurrent" if recurrent else "kv"

    @property
    def has_pageable_layers(self) -> bool:
        """At least one full-context attention layer whose KV the page
        pool can hold."""
        return (not self.cfg.is_encoder_decoder and
                self.cfg.attn_window == 0 and
                any(k == ATTN for k in self.cfg.layer_kinds))

    def capabilities(self) -> dict:
        """What the serving stack may enable for this architecture."""
        return {
            "state_kind": self.state_kind,
            "is_encoder_decoder": self.cfg.is_encoder_decoder,
            "has_pageable_layers": self.has_pageable_layers,
            "supports_bucketed_prefill": self.supports_bucketed_prefill,
            "supports_prefix_cache": self.supports_prefix_cache,
            "supports_speculative": self.supports_speculative,
            "has_vision_tower": self.cfg.vision is not None,
            "num_evidence_tokens": self.cfg.num_evidence_tokens,
        }

    @property
    def supports_bucketed_prefill(self) -> bool:
        """Right-padded bucketed prefill is exact for attention-only
        stacks (causality hides the pads from real positions); recurrent
        layers fold pads into their state, allclose but not bit for
        bit."""
        return (not self.cfg.is_encoder_decoder and
                all(k in (ATTN, LOCAL_ATTN) for k in self.cfg.layer_kinds))

    @property
    def supports_prefix_cache(self) -> bool:
        """Prompt-prefix KV reuse needs every layer's prompt state in the
        shared pages: all-attention, full-context, decoder-only
        (``repro/models/model.py:186``)."""
        return (not self.cfg.is_encoder_decoder and
                self.cfg.attn_window == 0 and
                all(k == ATTN for k in self.cfg.layer_kinds))

    @property
    def supports_speculative(self) -> bool:
        """Speculation rewinds a rejected position by not committing it,
        which only stateless-per-position KV layers allow: the prefix
        cache's predicate (``repro/models/model.py:216``)."""
        return self.supports_prefix_cache

    @property
    def has_vision_tower(self) -> bool:
        return self.cfg.vision is not None

    @property
    def num_evidence_tokens(self) -> int:
        return self.cfg.num_evidence_tokens


def build_model(cfg: ModelConfig, param_dtype=None, *, device=None,
                seed: int = 0, world=None) -> Model:
    """A seeded model; with ``world``, the rank's blocks of it."""
    return Model(cfg, param_dtype, device=device, seed=seed, world=world)
