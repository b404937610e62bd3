"""yi-34b — 01.AI Yi-34B, llama-architecture GQA.

[arXiv:2403.04652]: 60L, d_model=7168, 56 q heads, GQA kv=8, d_ff=20480,
vocab 64000.
"""
from repro_torch.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5e6,
    block_pattern=(ATTN,),
    mlp_activation="swiglu",
    source="arXiv:2403.04652",
)
