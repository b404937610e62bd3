"""mamba2-780m — Mamba-2 (SSD, state-space duality), attention-free.

[arXiv:2405.21060]: 48L, d_model=1536, no attention, vocab 50280,
ssm_state=128.
"""
from repro_torch.config import SSM, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                       # mamba2 blocks have no separate MLP
    vocab_size=50280,
    block_pattern=(SSM,),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=64),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
