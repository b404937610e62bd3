"""granite-34b — IBM Granite 34B Code, llama-architecture with MQA (kv=1).

[arXiv:2405.04324]: 88L, d_model=6144, 48 q heads, MQA kv=1, d_ff=24576,
vocab 49152.
"""
from repro_torch.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    block_pattern=(ATTN,),
    mlp_activation="gelu",        # granite code models use gelu MLP
    tie_embeddings=True,
    source="arXiv:2405.04324",
)
