"""Arch registry: ``--arch <id>`` → config + a uniform model API (the
counterpart of ``repro.models.registry``, all ten archs and six
families).

    api = get_model(cfg)
    params = api.init_params(generator)           # on the generator's device
    loss = api.loss_fn(params, batch)             # batch as train_batch_specs
    logits, cache = api.prefill(params, tokens, extra_embeds=None,
                                max_len=...)      # dense, moe, vlm
    logits, cache = api.prefill(params, tokens, max_len=...)  # ssm, hybrid
    logits, cache = api.prefill(params, tokens, frames, max_len=...)  # audio
    logits, cache = api.decode_step(params, cache, tokens, pos)
    cache = api.init_cache(batch, seq_len, device)

The xLSTM's prefill takes ``max_len`` and drops it (its state does not
grow), as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

ARCH_MODULES = {
    "granite-20b": "granite_20b",
    "internlm2-1.8b": "internlm2_1_8b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "deepseek-7b": "deepseek_7b",
    "xlstm-125m": "xlstm_125m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "hymba-1.5b": "hymba_1_5b",
    "llava-next-34b": "llava_next_34b",
    "whisper-large-v3": "whisper_large_v3",
}

ALL_ARCHS = tuple(ARCH_MODULES)

# family -> (the module under repro_torch.models that builds it, its
# parameters' nn.Module class)
FAMILY_MODULES = {
    "dense": ("transformer", "Transformer"),
    "moe": ("transformer", "Transformer"),
    "vlm": ("transformer", "Transformer"),
    "ssm": ("xlstm", "XLSTM"),
    "hybrid": ("hymba", "Hymba"),
    "audio": ("whisper", "Whisper"),
}


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[arch_id]}")
    return mod.CONFIG


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU tests (the JAX package's
    reductions, repro/models/registry.py:48)."""
    reductions: dict[str, Any] = dict(
        n_layers=4 if (cfg.slstm_every or cfg.global_attn_layers) else 2,
        d_model=128,
        n_heads=4,
        n_kv_heads=1 if cfg.n_kv_heads == 1 else (
            4 if cfg.n_kv_heads == cfg.n_heads else 2),
        d_ff=64 if cfg.n_experts else 256,
        vocab=512,
        max_position=4096,
        dtype="float32",
    )
    if cfg.n_experts:
        reductions.update(n_experts=8, top_k=min(cfg.top_k, 2),
                          capacity_factor=8.0)
    if cfg.sliding_window:
        reductions.update(sliding_window=16)
    if cfg.global_attn_layers:
        reductions.update(global_attn_layers=(0, 3))
    if cfg.n_encoder_layers:
        reductions.update(n_encoder_layers=2)
    return dataclasses.replace(cfg, **reductions)


def _seq_split(cfg: ModelConfig, seq_len: int) -> tuple[int, int]:
    """(frontend_tokens, text_tokens) for stub-frontend archs."""
    if cfg.frontend == "vision_patches":
        s_img = int(seq_len * cfg.frontend_tokens_ratio)
        return s_img, seq_len - s_img
    if cfg.frontend == "audio_frames":
        return max(1, seq_len // cfg.encoder_seq_ratio), seq_len
    return 0, seq_len


def model_module(cfg: ModelConfig):
    """The module of ``repro_torch.models`` that builds ``cfg``'s family."""
    if cfg.family not in FAMILY_MODULES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return importlib.import_module(
        f"repro_torch.models.{FAMILY_MODULES[cfg.family][0]}")


def params_class(cfg: ModelConfig):
    """The ``nn.Module`` class of ``cfg``'s parameters: ``cls(cfg,
    device)`` builds it empty."""
    return getattr(model_module(cfg), FAMILY_MODULES[cfg.family][1])


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    init_params: Callable   # (generator) -> params
    loss_fn: Callable       # (params, batch) -> scalar fp32 loss
    prefill: Callable       # (params, tokens, ..., max_len=None)
    #                         -> (logits, cache)
    decode_step: Callable   # (params, cache, tokens, pos) -> (logits, cache)
    init_cache: Callable    # (batch, seq_len, device) -> cache

    def train_batch_specs(self, shape: ShapeConfig) -> dict:
        """{name: (shape, dtype)} of a training batch for ``shape``: tokens
        and labels, and for a stub frontend extra_embeds [B, S', d] in the
        model's dtype. A vision model's S' patches come out of S (labels
        cover the text); an audio model's S' frames come on top of S
        (labels cover all S tokens), as in the JAX package."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        s_front, s_text = _seq_split(cfg, s)
        specs = {
            "tokens": ((b, s_text), torch.int32),
            "labels": ((b, s if cfg.frontend == "audio_frames" else s_text),
                       torch.int32),
        }
        if cfg.frontend != "none":
            specs["extra_embeds"] = ((b, s_front, cfg.d_model),
                                     getattr(torch, cfg.dtype))
        return specs

    def prefill_specs(self, shape: ShapeConfig) -> dict:
        """{name: (shape, dtype)} of prefill's inputs for ``shape``: the
        text tokens, and a vision model's patch embeddings
        (``extra_embeds``) or an audio model's frames [B, S', d] in the
        model's dtype, as in the JAX package."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        s_front, s_text = _seq_split(cfg, s)
        specs = {"tokens": ((b, s_text), torch.int32)}
        if cfg.frontend == "vision_patches":
            specs["extra_embeds"] = ((b, s_front, cfg.d_model),
                                     getattr(torch, cfg.dtype))
        if cfg.frontend == "audio_frames":
            specs["frames"] = ((b, s_front, cfg.d_model),
                               getattr(torch, cfg.dtype))
        return specs

    def decode_specs(self, shape: ShapeConfig) -> dict:
        """One decode step against a ``seq_len`` cache: {"cache": the
        cache on the meta device (its tensors carry shape and dtype, and
        hold nothing), "tokens", "pos": ((B,), int32)}."""
        b = shape.global_batch
        return {"cache": self.init_cache(b, shape.seq_len, device="meta"),
                "tokens": ((b,), torch.int32),
                "pos": ((b,), torch.int32)}

    def make_train_batch(self, shape: ShapeConfig,
                         generator: torch.Generator) -> dict:
        """A random batch of ``train_batch_specs(shape)`` on the
        generator's device: integers uniform over the vocabulary, embeddings
        normal × 0.02, drawn in the names' sorted order."""
        out = {}
        specs = self.train_batch_specs(shape)
        for name, (shp, dtype) in sorted(specs.items()):
            if dtype == torch.int32:
                out[name] = torch.randint(
                    0, self.cfg.vocab, shp, generator=generator,
                    device=generator.device, dtype=torch.int32)
            else:
                out[name] = (torch.randn(shp, generator=generator,
                                         device=generator.device)
                             * 0.02).to(dtype)
        return out


def get_model(cfg: ModelConfig) -> ModelApi:
    M = model_module(cfg)
    if cfg.family == "audio":
        def prefill(params, tokens, frames, max_len=None):
            return M.prefill(params, tokens, frames, cfg, max_len=max_len)
    elif cfg.family == "ssm":
        def prefill(params, tokens, max_len=None):
            return M.prefill(params, tokens, cfg)
    elif cfg.family == "hybrid":
        def prefill(params, tokens, max_len=None):
            return M.prefill(params, tokens, cfg, max_len=max_len)
    else:
        def prefill(params, tokens, extra_embeds=None, max_len=None):
            return M.prefill(params, tokens, cfg, extra_embeds=extra_embeds,
                             max_len=max_len)

    return ModelApi(
        cfg=cfg,
        init_params=lambda gen: M.init_params(gen, cfg),
        loss_fn=lambda p, b: M.loss_fn(p, b, cfg),
        prefill=prefill,
        decode_step=lambda p, c, t, pos: M.decode_step(p, c, t, pos, cfg),
        init_cache=lambda b, s, device="cuda": M.init_cache(cfg, b, s,
                                                            device),
    )
