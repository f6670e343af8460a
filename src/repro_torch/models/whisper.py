"""Whisper-large-v3's backbone: an encoder-decoder transformer (the
counterpart of ``repro.models.whisper``; arXiv:2212.04356).

The conv / mel frontend is a stub, as in the JAX package: the caller
gives post-conv frame embeddings [B, S_enc, d]. The encoder (bidirectional
self-attention) and the decoder (causal self-attention, then
cross-attention to the encoder's output) are real. LayerNorm and GELU;
the encoder adds sinusoidal positions, the decoder learned ones
(``pos_embed``, ``max_position`` rows). Every attention is the plain
``chunked_attention`` / ``decode_attention``, as the JAX package routes
it (no static window, so no flash kernel). ``loss_fn`` is the decoder's
next-token cross-entropy over the batch's frames (``extra_embeds``); with
grad mode on each encoder and decoder layer is recomputed in the backward,
as the JAX package's ``jax.checkpoint`` of its scan bodies.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
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


def _sinusoidal(s: int, d: int, device) -> torch.Tensor:
    """[s, d] fp32: sin then cos of position × 10000^(-i / (d/2 - 1))."""
    pos = torch.arange(s, device=device)[:, None]
    dim = torch.arange(d // 2, device=device)[None, :]
    log_base = torch.tensor(math.log(10000.0), dtype=torch.float32)
    inv = torch.exp(-log_base.to(device) * dim / (d // 2 - 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _ln(norm, x, cfg: ModelConfig):
    return C.layernorm_apply(norm, x, cfg.norm_eps)


class EncBlock(nn.Module):
    """ln1, attn, ln2, mlp."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = C.LayerNorm(cfg.d_model, device)
        self.attn = Attention(cfg, device)
        self.ln2 = C.LayerNorm(cfg.d_model, device)
        self.mlp = C.MLP(cfg, device)

    def init_(self, generator) -> None:
        for part in self.children():
            part.init_(generator)


class DecBlock(nn.Module):
    """ln1, self_attn, ln_x, cross_attn, ln2, mlp."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = C.LayerNorm(cfg.d_model, device)
        self.self_attn = Attention(cfg, device)
        self.ln_x = C.LayerNorm(cfg.d_model, device)
        self.cross_attn = Attention(cfg, device)
        self.ln2 = C.LayerNorm(cfg.d_model, device)
        self.mlp = C.MLP(cfg, device)

    def init_(self, generator) -> None:
        for part in self.children():
            part.init_(generator)


class Whisper(nn.Module):
    """embedding, pos_embed [max_position, d], encoder, enc_norm, decoder,
    final_norm."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embedding = C.Embedding(cfg, device)
        self.pos_embed = C._param((cfg.max_position, cfg.d_model),
                                  C.param_dtype(cfg), device)
        self.encoder = nn.ModuleList(
            EncBlock(cfg, device) for _ in range(cfg.n_encoder_layers))
        self.enc_norm = C.LayerNorm(cfg.d_model, device)
        self.decoder = nn.ModuleList(
            DecBlock(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = C.LayerNorm(cfg.d_model, device)

    def init_(self, generator) -> None:
        self.embedding.init_(generator)
        C.embed_init(self.pos_embed, generator)
        for block in (*self.encoder, self.enc_norm, *self.decoder,
                      self.final_norm):
            block.init_(generator)


def init_params(generator: torch.Generator, cfg: ModelConfig) -> Whisper:
    """Random weights on the generator's device, in ``cfg.dtype``."""
    params = Whisper(cfg, generator.device)
    params.init_(generator)
    return params


def _enc_block(block: EncBlock, x, cfg: ModelConfig):
    q, k, v = qkv_project(block.attn, _ln(block.ln1, x, cfg))
    x = x + out_project(block.attn, chunked_attention(q, k, v, 0,
                                                      causal=False))
    return x + C.mlp_apply(block.mlp, _ln(block.ln2, x, cfg))


def encode(params: Whisper, frames, cfg: ModelConfig):
    """frames [B, S_enc, d] stub embeddings -> encoder states; under
    autograd each layer is recomputed in the backward
    (``common.remat_call``)."""
    s = frames.shape[1]
    x = frames + _sinusoidal(s, cfg.d_model, frames.device).to(frames.dtype)
    for block in params.encoder:
        x = C.remat_call(_enc_block, block, x, cfg)
    return _ln(params.enc_norm, x, cfg)


def _cross_kv(params: Whisper, enc_out):
    """Each decoder layer's cross-attention K and V of the encoder output,
    stacked to [L, B, S_enc, H, D]."""
    ks = [torch.einsum("bsd,dhk->bshk", enc_out, blk.cross_attn.wk)
          for blk in params.decoder]
    vs = [torch.einsum("bsd,dhk->bshk", enc_out, blk.cross_attn.wv)
          for blk in params.decoder]
    return torch.stack(ks), torch.stack(vs)


def _dec_block(block: DecBlock, x, enc_k, enc_v, cfg: ModelConfig,
               decode_ctx=None):
    """A decoder block over the whole sequence (``decode_ctx`` None), or
    one token against the self-attention cache: decode_ctx = (k_cache,
    v_cache, kv_pos, pos, slot), the caches written in place at ``slot``.
    Returns (x, (k, v)): the sequence's K and V, or the caches."""
    q, k, v = qkv_project(block.self_attn, _ln(block.ln1, x, cfg))
    if decode_ctx is None:
        attn = chunked_attention(q, k, v, 0, causal=True)
    else:
        kc, vc, kv_pos, pos, slot = decode_ctx
        bidx = torch.arange(x.shape[0], device=x.device)
        kc.index_put_((bidx, slot), k[:, 0])
        vc.index_put_((bidx, slot), v[:, 0])
        attn = decode_attention(q, kc, vc, kv_pos, pos, 0)
        k, v = kc, vc
    x = x + out_project(block.self_attn, attn)
    qx = torch.einsum("bsd,dhk->bshk", _ln(block.ln_x, x, cfg),
                      block.cross_attn.wq)
    cross = chunked_attention(qx, enc_k, enc_v, 0, causal=False)
    x = x + out_project(block.cross_attn, cross)
    x = x + C.mlp_apply(block.mlp, _ln(block.ln2, x, cfg))
    return x, (k, v)


def forward_hidden(params: Whisper, tokens, frames, cfg: ModelConfig):
    """The decoder's final hidden states [B, S, d] over tokens [B, S],
    cross-attending to the encoded frames [B, S_enc, d]."""
    enc_ks, enc_vs = _cross_kv(params, encode(params, frames, cfg))
    s = tokens.shape[1]
    x = C.embed_tokens(params.embedding, tokens) + params.pos_embed[:s][None]
    for block, ek, ev in zip(params.decoder, enc_ks, enc_vs):
        x, _ = C.remat_call(_dec_block, block, x, ek, ev, cfg)
    return _ln(params.final_norm, x, cfg)


def loss_fn(params: Whisper, batch: dict, cfg: ModelConfig):
    """Next-token cross-entropy (``repro.models.whisper.loss_fn``). batch:
    tokens [B, S], labels [B, S], extra_embeds [B, S_enc, d] (the
    frames)."""
    x = forward_hidden(params, batch["tokens"], batch["extra_embeds"], cfg)
    return C.chunked_xent_loss(params.embedding, x, batch["labels"])


# -- serving -------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cuda") -> dict:
    """Self-attention k, v [L, B, seq_len, H, D], kv_pos [B, seq_len], and
    cross-attention cross_k, cross_v [L, B, S_enc, H, D] (S_enc = seq_len
    // encoder_seq_ratio)."""
    dt = C.param_dtype(cfg)
    l = cfg.n_layers
    s_enc = max(1, seq_len // cfg.encoder_seq_ratio)
    kv = (l, batch, seq_len, cfg.n_kv_heads, cfg.d_head)
    cross = (l, batch, s_enc, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
        "kv_pos": torch.full((batch, seq_len), -1, dtype=torch.int32,
                             device=device),
        "cross_k": torch.zeros(cross, dtype=dt, device=device),
        "cross_v": torch.zeros(cross, dtype=dt, device=device),
    }


def prefill(params: Whisper, tokens, frames, cfg: ModelConfig, *,
            max_len: int | None = None):
    """Encode the frames, then the prompt pass. tokens [B, S], frames [B,
    S_enc, d]. Returns (last-token logits [B, V] fp32, cache)."""
    enc_ks, enc_vs = _cross_kv(params, encode(params, frames, cfg))
    b, s = tokens.shape
    dev = tokens.device
    x = C.embed_tokens(params.embedding, tokens) + params.pos_embed[:s][None]
    ks, vs = [], []
    for block, ek, ev in zip(params.decoder, enc_ks, enc_vs):
        x, (k, v) = _dec_block(block, x, ek, ev, cfg)
        ks.append(k)
        vs.append(v)
    x = _ln(params.final_norm, x, cfg)
    ks, vs = torch.stack(ks), torch.stack(vs)
    s_alloc = max_len or s
    if s_alloc > s:  # decode headroom
        pad = s_alloc - s
        ks = F.pad(ks, (0, 0, 0, 0, 0, pad))
        vs = F.pad(vs, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.cat([torch.arange(s, device=dev),
                            torch.full((pad,), -1, device=dev)])
    else:
        kv_pos = torch.arange(s, device=dev)
    cache = {"k": ks.contiguous(), "v": vs.contiguous(),
             "kv_pos": kv_pos.to(torch.int32).expand(b, -1).contiguous(),
             "cross_k": enc_ks, "cross_v": enc_vs}
    return C.logits_last(params.embedding, x[:, -1]), cache


def decode_step(params: Whisper, cache: dict, tokens, pos, cfg: ModelConfig):
    """One token a sequence: tokens [B], pos [B] its absolute position
    (the learned position's row). The self-attention cache is updated in
    place. Returns (logits [B, V] fp32, cache)."""
    b = tokens.shape[0]
    x = (C.embed_tokens(params.embedding, tokens[:, None])
         + params.pos_embed[pos.long()][:, None])
    s_alloc = cache["k"].shape[2]
    slot = (pos % s_alloc).long()
    bidx = torch.arange(b, device=x.device)
    cache["kv_pos"].index_put_((bidx, slot), pos.to(torch.int32))
    for layer, block in enumerate(params.decoder):
        x, _ = _dec_block(
            block, x, cache["cross_k"][layer], cache["cross_v"][layer], cfg,
            decode_ctx=(cache["k"][layer], cache["v"][layer],
                        cache["kv_pos"], pos, slot))
    x = _ln(params.final_norm, x, cfg)
    return C.logits_last(params.embedding, x[:, 0]), cache
