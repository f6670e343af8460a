"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024(per-expert)
vocab=50304, MoE 64 experts top-8 [arXiv:2409.02060; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    mlp_type="swiglu",
    n_experts=64,
    top_k=8,
)
