"""seamless-m4t-large-v2 — Meta SeamlessM4T v2 large (text/speech enc-dec).

[arXiv:2308.11596]: 24L decoder (+24L encoder), d_model=1024, 16 heads
(kv=16 i.e. MHA), d_ff=8192, vocab 256206. Multimodal: the speech frontend
(mel + conformer conv) is a stub; requests carry precomputed frame
embeddings, which the encoder consumes.
"""
from repro_torch.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    block_pattern=(ATTN,),
    mlp_activation="gelu",
    is_encoder_decoder=True,
    num_encoder_layers=24,
    num_evidence_tokens=512,      # precomputed audio frame embeddings
    evidence_dim=1024,
    source="arXiv:2308.11596",
)
