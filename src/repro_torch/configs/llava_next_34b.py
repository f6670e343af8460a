"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling [hf:llava-hf/llava-v1.6-*]. The vision tower is a
STUB: the caller supplies precomputed anyres patch embeddings [B, S_img, d]
(S_img = seq_len/4, ``models.registry._seq_split``); the LM backbone is
real."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    mlp_type="swiglu",
    frontend="vision_patches",
    frontend_tokens_ratio=0.25,
)
