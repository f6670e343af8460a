"""whisper-large-v3 [audio]: enc-dec, 32L(+32L enc) d_model=1280 20H
d_ff=5120 vocab=51866, conv frontend STUB [arXiv:2212.04356].
input_specs() supplies post-conv frame embeddings [B, S/2, d]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    mlp_type="gelu",
    use_rope=False,
    max_position=32768,
    n_encoder_layers=32,
    encoder_seq_ratio=2,
    frontend="audio_frames",
)
