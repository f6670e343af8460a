"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attn+mamba heads [arXiv:2411.13676; hf].
SWA(1024) everywhere except global layers {0, 16, 31} (first/middle/last)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    mlp_type="swiglu",
    sliding_window=1024,
    global_attn_layers=(0, 16, 31),
    ssm_state=16,
    parallel_ssm_heads=True,
)
