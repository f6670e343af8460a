"""Model and input-shape configurations, as pure dataclasses.

The counterpart of ``repro.configs.base``, kept as this package's own copy
because ``repro.configs`` belongs to the JAX package. Fields, defaults and
derived values are the same; ``tests/test_torch_models.py`` holds them
field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
ShapeKind = Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: ShapeKind

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode")

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description (every field of the JAX package's)."""

    arch_id: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 → d_model // n_heads

    # attention flavour
    mlp_type: Literal["swiglu", "gelu", "none"] = "swiglu"
    sliding_window: int = 0           # 0 → full attention
    global_attn_layers: tuple[int, ...] = ()  # hybrid: layers w/ full attn
    rope_theta: float = 10_000.0
    use_rope: bool = True             # False → learned absolute positions
    max_position: int = 1_048_576     # learned-pos table size cap
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0                # 0 → dense
    top_k: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0

    # SSM / recurrent
    ssm_state: int = 0
    slstm_every: int = 0
    conv_kernel: int = 4

    # hybrid
    parallel_ssm_heads: bool = False

    # encoder-decoder
    n_encoder_layers: int = 0
    encoder_seq_ratio: int = 1

    # modality frontend stubs
    frontend: Literal["none", "vision_patches", "audio_frames"] = "none"
    frontend_tokens_ratio: float = 0.0

    # numerics
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads (GQA)")

    @property
    def is_subquadratic(self) -> bool:
        return self.family == "ssm" or self.sliding_window > 0

    @property
    def has_kv_cache(self) -> bool:
        return self.family != "ssm"

    def supports_shape(self, shape: ShapeConfig) -> bool:
        if shape.name == "long_500k":
            return self.is_subquadratic
        return True

    def param_count(self, *, active_only: bool = False) -> int:
        """Parameter estimate for the 6·N·D roofline term, as the JAX
        package counts it (xLSTM and Mamba by their projections only)."""
        d, dh = self.d_model, self.d_head
        attn = (d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh)
                + (self.n_heads * dh) * d)
        per_mlp = {"swiglu": 3, "gelu": 2}.get(self.mlp_type, 0) * d * self.d_ff
        if self.n_experts:
            experts = (self.top_k + self.n_shared_experts if active_only
                       else self.n_experts)
            block_mlp = experts * per_mlp + d * self.n_experts
        else:
            block_mlp = per_mlp
        if self.family == "ssm":  # up/down (4d²) + qkv/gates (~2d²)
            per_layer = 6 * d * d
        elif self.parallel_ssm_heads:  # + mamba in/out projections
            per_layer = attn + block_mlp + 2 * d * d
        else:
            per_layer = attn + block_mlp
        total = self.n_layers * per_layer
        if self.n_encoder_layers:  # self- and cross-attention
            total += self.n_encoder_layers * (2 * attn + block_mlp)
        return total + self.vocab * d * (1 if self.tie_embeddings else 2)
