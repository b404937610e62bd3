"""recurrentgemma-2b — Google RecurrentGemma (Griffin), RG-LRU + local attn.

[arXiv:2402.19427]: 26L, d_model=2560, 10 q heads, MQA kv=1, d_ff=7680,
vocab 256000. Block pattern: 2 recurrent (RG-LRU) blocks then 1 local
attention block (1:2 ratio), local window 2048.
"""
from repro_torch.config import LOCAL_ATTN, RGLRU, ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    local_window=2048,
    block_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    mlp_activation="gelu",
    rglru=RGLRUConfig(lru_width=2560),
    tie_embeddings=True,
    source="arXiv:2402.19427",
)
