"""qwen3-0.6b — Qwen3 0.6B dense with qk-norm.

[hf:Qwen/Qwen3-8B family card]: 28L, d_model=1024, 16 q heads, GQA kv=8,
d_ff=3072, vocab 151936, qk_norm, head_dim 128, tied embeddings.
"""
from repro_torch.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    head_dim=128,
    rope_theta=1e6,
    block_pattern=(ATTN,),
    mlp_activation="swiglu",
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B",
)
