"""qwen2.5-32b — Qwen2.5 32B dense.

[hf:Qwen/Qwen2.5-0.5B family card]: 64L, d_model=5120, 40 q heads, GQA kv=8,
d_ff=27648, vocab 152064, QKV bias.
"""
from repro_torch.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    block_pattern=(ATTN,),
    mlp_activation="swiglu",
    source="hf:Qwen/Qwen2.5-0.5B",
)
