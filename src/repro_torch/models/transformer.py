"""Decoder-only transformer LM (the counterpart of
``repro.models.transformer``): the dense family (internlm2-1.8b,
deepseek-7b, granite-20b, deepseek-coder-33b), the mixture-of-experts
family (olmoe-1b-7b, mixtral-8x22b: ``models/moe.py`` in place of the MLP)
and the VLM backbone (llava-next-34b: precomputed patch embeddings,
``extra_embeds``, go before the text). Positions are RoPE or, with
``use_rope=False``, a learned absolute table (``pos_embed``).

As in the JAX package, the module builds a transformer over any config,
whatever its family (the serving engine does so for every arch). The JAX
package stacks the layers and drives them with ``lax.scan``; here they
are an ``nn.ModuleList`` and a Python loop. Per-layer windows stay data
(``window_schedule``). ``loss_fn`` is the next-token cross-entropy; with
grad mode on, ``forward_hidden`` recomputes each block in the backward
(``torch.utils.checkpoint``), as the JAX package's ``jax.checkpoint`` of
its scan body does.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C
from repro_torch.models.attention import (
    Attention,
    chunked_attention,
    decode_attention,
    out_project,
    qkv_project,
)
from repro_torch.models.moe import MoE, moe_apply


def window_schedule(cfg: ModelConfig) -> torch.Tensor:
    """[L] int32 per-layer window on the host (0 = full attention). A
    global layer past the last (a depth-cut config) is dropped, as the JAX
    package's scatter drops an out-of-range index."""
    win = torch.full((cfg.n_layers,), cfg.sliding_window, dtype=torch.int32)
    win[[i for i in cfg.global_attn_layers if i < cfg.n_layers]] = 0
    return win


def cache_alloc_len(cfg: ModelConfig, seq_len: int) -> int:
    """Ring-buffer allocation: sliding-window-everywhere archs cap the cache
    at the window; any full-attention layer forces a full-length cache."""
    if cfg.sliding_window > 0 and not cfg.global_attn_layers:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def _norm(norm: C.RMSNorm, x, cfg: ModelConfig):
    return C.rmsnorm_apply(norm, x, cfg.norm_eps)


def _ffn(block: "Block", x, cfg: ModelConfig):
    if cfg.n_experts:
        return moe_apply(block.moe, x, cfg)
    return C.mlp_apply(block.mlp, x)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = C.RMSNorm(cfg.d_model, device)
        self.attn = Attention(cfg, device)
        self.ln2 = C.RMSNorm(cfg.d_model, device)
        if cfg.n_experts:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = C.MLP(cfg, device)

    def init_(self, generator) -> None:
        for part in self.children():  # ln1, attn, ln2, then moe or mlp
            part.init_(generator)


def block_init(cfg: ModelConfig, generator) -> Block:
    block = Block(cfg, generator.device)
    block.init_(generator)
    return block


def block_forward(block: Block, x, positions, window: int, cfg: ModelConfig):
    """Full-sequence (prefill) block. x [B, S, d], positions [S]. Returns
    (x, (k, v)) so that prefill can build the KV cache."""
    h = _norm(block.ln1, x, cfg)
    q, k, v = qkv_project(block.attn, h)
    if cfg.use_rope:
        q = C.apply_rope(q, positions, cfg.rope_theta)
        k = C.apply_rope(k, positions, cfg.rope_theta)
    # uniform-window archs certify the static window: the flash kernel's call
    ws = cfg.sliding_window if not cfg.global_attn_layers else -1
    attn = chunked_attention(q, k, v, window, causal=True, window_static=ws)
    x = x + out_project(block.attn, attn)
    x = x + _ffn(block, _norm(block.ln2, x, cfg), cfg)
    return x, (k, v)


def block_decode(block: Block, x, k_cache, v_cache, kv_pos, pos, slot,
                 window: int, cfg: ModelConfig):
    """Single-token decode block. x [B, 1, d]; caches [B, S_alloc, Hkv, D]
    are updated in place at ``slot`` [B]. Returns x."""
    h = _norm(block.ln1, x, cfg)
    q, k, v = qkv_project(block.attn, h)
    if cfg.use_rope:
        q = C.apply_rope(q, pos[:, None], cfg.rope_theta)
        k = C.apply_rope(k, pos[:, None], cfg.rope_theta)
    bidx = torch.arange(x.shape[0], device=x.device)
    k_cache.index_put_((bidx, slot), k[:, 0])
    v_cache.index_put_((bidx, slot), v[:, 0])
    attn = decode_attention(q, k_cache, v_cache, kv_pos, pos, window)
    x = x + out_project(block.attn, attn)
    return x + _ffn(block, _norm(block.ln2, x, cfg), cfg)


class Transformer(nn.Module):
    """embedding (embed [V, d], unembed [d, V]), layers, final_norm, and
    with ``use_rope=False`` pos_embed [max_position, d]."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embedding = C.Embedding(cfg, device)
        self.layers = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = C.RMSNorm(cfg.d_model, device)
        self.pos_embed = (None if cfg.use_rope else C._param(
            (cfg.max_position, cfg.d_model), C.param_dtype(cfg), device))

    def init_(self, generator) -> None:
        self.embedding.init_(generator)
        for block in self.layers:
            block.init_(generator)
        self.final_norm.init_(generator)
        if self.pos_embed is not None:
            C.embed_init(self.pos_embed, generator)


def init_params(generator: torch.Generator, cfg: ModelConfig) -> Transformer:
    """Random weights on the generator's device, in ``cfg.dtype``."""
    params = Transformer(cfg, generator.device)
    params.init_(generator)
    return params


def _input_embeds(params: Transformer, tokens, extra_embeds=None,
                  position_offset=0):
    """Token embeddings [B, S, d], after the stub frontend's precomputed
    ``extra_embeds`` [B, S', d] where given (cast to the model's dtype),
    and positions [S] over the whole sequence from ``position_offset``
    (an int, or [B, 1] per sequence); learned positions are added."""
    x = C.embed_tokens(params.embedding, tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device) + position_offset
    if params.pos_embed is not None:
        x = x + params.pos_embed[positions.long()]
    return x, positions


def forward_hidden(params: Transformer, tokens, cfg: ModelConfig, *,
                   extra_embeds=None, collect_kv: bool = False):
    """Final hidden states [B, S, d] (and, with ``collect_kv``, the
    per-layer K and V stacked to [L, B, S, Hkv, D]); S counts the
    ``extra_embeds`` rows before the text. Under autograd each block is
    recomputed in the backward (``common.remat_call``)."""
    x, positions = _input_embeds(params, tokens, extra_embeds)
    ks, vs = [], []
    for block, win in zip(params.layers, window_schedule(cfg).tolist()):
        x, (k, v) = C.remat_call(block_forward, block, x, positions, win,
                                 cfg)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = _norm(params.final_norm, x, cfg)
    return (x, (torch.stack(ks), torch.stack(vs))) if collect_kv else x


def loss_fn(params: Transformer, batch: dict, cfg: ModelConfig):
    """Next-token cross-entropy (``repro.models.transformer.loss_fn``).
    batch: tokens [B, S], labels [B, S], and for a stub frontend
    extra_embeds [B, S', d], whose positions take no loss (label -1)."""
    extra = batch.get("extra_embeds")
    x = forward_hidden(params, batch["tokens"], cfg, extra_embeds=extra)
    labels = batch["labels"]
    if extra is not None:
        pad = labels.new_full(extra.shape[:2], -1)
        labels = torch.cat([pad, labels], dim=1)
    return C.chunked_xent_loss(params.embedding, x, labels)


# -- serving -------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cuda") -> dict:
    s_alloc = cache_alloc_len(cfg, seq_len)
    shape = (cfg.n_layers, batch, s_alloc, cfg.n_kv_heads, cfg.d_head)
    dt = C.param_dtype(cfg)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "kv_pos": torch.full((batch, s_alloc), -1, dtype=torch.int32,
                             device=device),
    }


def prefill(params: Transformer, tokens, cfg: ModelConfig, *,
            extra_embeds=None, max_len: int | None = None):
    """Full prompt pass. Returns (last-token logits [B, V] fp32, cache).

    ``max_len`` reserves decode headroom in the cache (default: the prompt
    length, ``extra_embeds`` rows included)."""
    x, (ks, vs) = forward_hidden(params, tokens, cfg,
                                 extra_embeds=extra_embeds, collect_kv=True)
    b, s = x.shape[0], x.shape[1]
    dev = x.device
    s_alloc = cache_alloc_len(cfg, max_len or s)
    if s_alloc < s:  # ring buffer: keep the last window, in slot order
        kept_pos = torch.arange(s - s_alloc, s, device=dev)
        inv = torch.argsort(kept_pos % s_alloc)
        ks = ks[:, :, s - s_alloc:][:, :, inv]
        vs = vs[:, :, s - s_alloc:][:, :, inv]
        kv_pos = kept_pos[inv].to(torch.int32).expand(b, s_alloc)
    elif s_alloc > s:  # decode headroom
        pad = s_alloc - s
        ks = torch.nn.functional.pad(ks, (0, 0, 0, 0, 0, pad))
        vs = torch.nn.functional.pad(vs, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.cat([
            torch.arange(s, device=dev),
            torch.full((pad,), -1, device=dev),
        ]).to(torch.int32).expand(b, s_alloc)
    else:
        kv_pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    cache = {"k": ks.contiguous(), "v": vs.contiguous(),
             "kv_pos": kv_pos.contiguous()}
    return C.logits_last(params.embedding, x[:, -1]), cache


def decode_step(params: Transformer, cache: dict, tokens, pos,
                cfg: ModelConfig):
    """One token for every sequence: tokens [B], pos [B] absolute position
    of the new token. The cache is updated in place. Returns (logits [B, V]
    fp32, cache)."""
    x, _ = _input_embeds(params, tokens[:, None],
                         position_offset=pos[:, None])
    s_alloc = cache["k"].shape[2]
    slot = (pos % s_alloc).long()
    bidx = torch.arange(x.shape[0], device=x.device)
    cache["kv_pos"].index_put_((bidx, slot), pos.to(torch.int32))
    windows = window_schedule(cfg).tolist()
    for layer, (block, win) in enumerate(zip(params.layers, windows)):
        x = block_decode(block, x, cache["k"][layer], cache["v"][layer],
                         cache["kv_pos"], pos, slot, win, cfg)
    x = _norm(params.final_norm, x, cfg)
    return C.logits_last(params.embedding, x[:, 0]), cache
