"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks [arXiv:2405.04517]. Every 4th layer is sLSTM (9 mLSTM + 3 sLSTM)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    mlp_type="none",
    slstm_every=4,
    use_rope=False,
)
