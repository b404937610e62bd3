"""granite-moe-3b-a800m — IBM Granite 3.0 MoE.

[hf:ibm-granite/granite-3.0-1b-a400m-base] (family card; assigned 3b-a800m
variant): 32L, d_model=1536, 24 q heads with GQA kv=8, per-expert d_ff=512,
vocab 49155, 40 experts top-8.
"""
from repro_torch.config import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,                    # per-expert hidden width
    vocab_size=49155,
    block_pattern=(ATTN,),
    mlp_activation="swiglu",
    moe=MoEConfig(num_experts=40, top_k=8, expert_d_ff=512),
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
