"""internvl2-2b — InternVL2 2B VLM (InternViT-300M + InternLM2-1.8B).

[arXiv:2404.16821]: language backbone 24L, d_model=2048, 16 q heads,
GQA kv=8, d_ff=8192, vocab 92553. 256 patch tokens per 448x448 image
tile (InternViT's post-pixel-shuffle grid: (448/28)^2 = 256), encoded
by the in-repo vision tower (an InternViT-shaped stand-in: same grid
and token count, far fewer layers).
"""
from repro_torch.config import ATTN, ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    block_pattern=(ATTN,),
    mlp_activation="swiglu",
    num_evidence_tokens=256,      # ViT patch embeddings per image tile
    evidence_dim=2048,
    vision=VisionConfig(image_h=448, image_w=448, patch=28,
                        num_layers=4, d_model=768, num_heads=12, d_ff=3072),
    source="arXiv:2404.16821",
)
