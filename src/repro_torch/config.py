"""Configuration dataclasses of the port.

Copies of ``ModelConfig``, ``MoEConfig``, ``SSMConfig``, ``RGLRUConfig``,
``VisionConfig``, ``ShapeConfig`` (with ``INPUT_SHAPES``),
``SamplingConfig``, ``CAMDConfig``, ``PagedKVConfig`` and ``TrainConfig``
from the JAX package's ``repro/config.py``, field for field, so a config
built for one package describes the same model, input shape, serving and
training setup in the other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Block kinds of ``block_pattern`` (``repro/config.py:17-20``).
ATTN = "attn"            # full (optionally windowed) self-attention block
LOCAL_ATTN = "local"     # sliding-window-only self-attention block
SSM = "ssm"              # Mamba2 SSD block
RGLRU = "rglru"          # RecurrentGemma RG-LRU recurrent block


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings of the MLP sub-block."""
    num_experts: int
    top_k: int
    # d_ff of each expert (per-expert hidden width).
    expert_d_ff: int
    # weight of the auxiliary load-balance loss during training.
    aux_loss_weight: float = 0.01
    # expert capacity factor (GShard); tokens beyond capacity are dropped.
    capacity_factor: float = 1.25
    # token group size of the capacity dispatch.
    group_size: int = 256
    # router jitter noise (training only)
    router_noise: float = 0.0
    # number of shared (always-on) experts, e.g. DeepSeek/Kimi style.
    num_shared_experts: int = 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) settings."""
    state_dim: int = 128          # N: SSM state size
    head_dim: int = 64            # P: channels per SSD head
    expand: int = 2               # inner dim = expand * d_model
    chunk_size: int = 64          # SSD block-diagonal chunk length
    conv_width: int = 4           # depthwise causal conv width


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU settings."""
    lru_width: int = 0            # 0 => same as d_model
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = (RGLRU, RGLRU, LOCAL_ATTN)  # 1:2 attn:rglru


@dataclass(frozen=True)
class VisionConfig:
    """ViT vision tower of the image-prefill serving path: an image of
    ``image_h`` x ``image_w`` yields ``n_patches`` embeddings, which must
    equal the LM's ``num_evidence_tokens``."""
    image_h: int = 336
    image_w: int = 336
    patch: int = 14
    channels: int = 3
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    d_ff: int = 512

    @property
    def n_patches(self) -> int:
        return (self.image_h // self.patch) * (self.image_w // self.patch)

    @staticmethod
    def for_tokens(n: int, patch: int = 4, **kw) -> "VisionConfig":
        """A tower whose patch grid yields exactly ``n`` tokens (square
        grid when ``n`` is a perfect square, else ``n`` x 1)."""
        r = int(round(n ** 0.5))
        gh, gw = (r, r) if r * r == n else (n, 1)
        return VisionConfig(image_h=gh * patch, image_w=gw * patch,
                            patch=patch, **kw)


@dataclass(frozen=True)
class ModelConfig:
    """One architecture (the reference's fields)."""
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                # query heads (0 for attn-free archs)
    num_kv_heads: int             # kv heads (GQA); 1 => MQA
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_window: int = 0          # 0 => full causal; >0 => sliding window
    local_window: int = 2048      # window of LOCAL_ATTN blocks (hybrids)
    block_pattern: Tuple[str, ...] = (ATTN,)   # tiled over num_layers
    mlp_activation: str = "swiglu"             # the LM's; the tower's is gelu
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    num_evidence_tokens: int = 0
    evidence_dim: int = 0
    vision: Optional[VisionConfig] = None      # None: precomputed evidence
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads == 0:
            return 0
        return self.d_model // self.num_heads

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def num_params(self) -> int:
        """Analytic parameter count, embeddings and per-layer blocks, as
        ``repro.config.ModelConfig.num_params`` counts it (the vision
        tower and the evidence projection are not counted there either;
        the SSD block's A_log, D and dt_bias and the RG-LRU's conv bias
        and lambda are not counted alike). An encoder-decoder stack adds
        its encoder layers and each decoder layer's cross-attention and
        its norm (``repro/config.py:226-233``); the encoder's final norm
        is not counted there either."""
        d, v = self.d_model, self.vocab_size
        n = v * d if self.tie_embeddings else 2 * v * d
        hd = self.resolved_head_dim
        per = 3 if self.mlp_activation == "swiglu" else 2
        if self.moe is None:
            mlp = per * d * self.d_ff
        else:
            e = self.moe
            mlp = (e.num_experts + e.num_shared_experts) * per * d * \
                e.expert_d_ff + d * e.num_experts
        for kind in self.layer_kinds:
            n += 2 * d                         # two norms
            if kind in (ATTN, LOCAL_ATTN):
                q = self.num_heads * hd
                kv = self.num_kv_heads * hd
                n += 2 * d * q + 2 * d * kv
            elif kind == SSM:
                s = self.ssm
                inner = s.expand * d
                heads = inner // s.head_dim
                n += d * (2 * inner + 2 * s.state_dim + heads) + inner * d
                n += s.conv_width * (inner + 2 * s.state_dim)
            elif kind == RGLRU:
                w = self.rglru.lru_width or d
                n += 2 * d * w + w * d + 2 * w   # in/out proj + gates
            if kind in (ATTN, LOCAL_ATTN, RGLRU):
                n += mlp
        if self.is_encoder_decoder:
            attn = 2 * d * self.num_heads * hd + \
                2 * d * self.num_kv_heads * hd
            n += self.num_encoder_layers * (attn + per * d * self.d_ff
                                            + 2 * d)
            n += self.num_layers * (attn + d)
        return n

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """The reference's CPU-smoke-size variant of a config, experts,
        SSD and RG-LRU widths, evidence and vision tower included (same
        rule as ``repro.config.ModelConfig.reduced``)."""
        kw = dict(
            num_layers=max(2, min(len(self.block_pattern), 3)),
            d_model=256, d_ff=512, vocab_size=512, head_dim=64)
        if self.num_heads:
            kw["num_heads"] = 4
            kw["num_kv_heads"] = min(self.num_kv_heads, 2) \
                if self.num_kv_heads > 1 else 1
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, expert_d_ff=128,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                capacity_factor=4.0)  # dropless in practice at smoke scale
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=32, chunk_size=16)
        if self.rglru is not None:
            kw["rglru"] = dataclasses.replace(self.rglru, lru_width=256)
        if self.is_encoder_decoder:
            kw["num_encoder_layers"] = 2
        if self.num_evidence_tokens:
            kw["num_evidence_tokens"] = 8
            kw["evidence_dim"] = min(self.evidence_dim, 256) or 256
            if self.vision is not None:
                kw["vision"] = VisionConfig.for_tokens(
                    8, patch=4, num_layers=2, d_model=64, num_heads=2,
                    d_ff=128)
        if self.attn_window:
            kw["attn_window"] = 64
        kw["local_window"] = 64
        return self.with_overrides(**kw)


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned input shape (``repro/config.py:252-258``)."""
    name: str
    seq_len: int
    global_batch: int
    mode: str            # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class CAMDConfig:
    """Coverage-Aware Multimodal Decoding hyper-parameters (paper §5.1)."""
    lambda_g: float = 0.9
    lambda_c: float = 0.7
    delta: float = 0.05
    tau: float = 0.90
    cluster_threshold: float = 0.85
    max_clusters: int = 16
    max_rounds: int = 8
    samples_per_round: int = 4
    min_samples: int = 2
    dirichlet_prior: float = 0.5
    score_scale: float = 1.0
    guidance_strength: float = 1.0
    patience: int = 3
    ei_cost_per_token: float = 1e-4


@dataclass(frozen=True)
class PagedKVConfig:
    """Paged KV-cache settings of the serving engine (paged impls).
    ``num_pages=0`` sizes the pool to the dense worst case
    (slots * cache_len / page_size + 1 quarantine page)."""
    page_size: int = 16
    num_pages: int = 0
    kv_dtype: str = "auto"
    kv_byte_budget: int = 0


@dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.7
    top_p: float = 0.9
    top_k: int = 0                 # 0 = off
    min_p: float = 0.0             # 0 = off
    repetition_penalty: float = 1.05
    max_new_tokens: int = 64


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"       # cosine | linear | constant
    remat: bool = True             # activation checkpointing over layers
    unroll: bool = False           # the reference's dry-run cost model
                                   # unrolls its layer scan; the port's
                                   # layers are a Python loop already
    microbatches: int = 1          # gradient-accumulation splits of the
                                   # global batch (bounds activation memory)
    seed: int = 0
