"""llava-1.5-7b — the paper's primary evaluation backbone (LM side of
LLaVA-1.5: Vicuna-7B + CLIP ViT-L/14 projector).

[arXiv:2310.03744 / paper §5.1]: 32L, d_model=4096, 32 heads MHA, d_ff=11008,
vocab 32000; 576 patch embeddings per 336x336 image (ViT-L/14 grid:
(336/14)^2 = 576), encoded by the in-repo vision tower (a CLIP-shaped
stand-in: same patch grid and token count, far fewer layers).
"""
from repro_torch.config import ATTN, ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="llava-1.5-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    block_pattern=(ATTN,),
    mlp_activation="swiglu",
    num_evidence_tokens=576,
    evidence_dim=4096,
    vision=VisionConfig(image_h=336, image_w=336, patch=14,
                        num_layers=4, d_model=1024, num_heads=16, d_ff=4096),
    source="arXiv:2310.03744",
)
