"""deepseek-7b [dense]: 30L d_model=4096 32H (kv=32) d_ff=11008
vocab=102400, swiglu MLP [arXiv:2401.02954]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    mlp_type="swiglu",
)
