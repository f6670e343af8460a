"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (kv=8) d_ff=19200
vocab=32256, swiglu MLP [arXiv:2401.14196]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab=32256,
    mlp_type="swiglu",
)
