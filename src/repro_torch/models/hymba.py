"""Hymba-1.5B: a hybrid-head LM (the counterpart of
``repro.models.hymba``; arXiv:2411.13676). Every layer runs attention
heads and Mamba (SSM) heads in parallel on the same input, normalises
each path's output and fuses them. Attention is sliding-window but for a
few global layers (first, middle, last): per-layer data
(``transformer.window_schedule``). Meta tokens are stubbed, as in the
JAX package.

Attention runs the plain ``chunked_attention`` / ``decode_attention``,
as the JAX package routes it (no static window certified, so no flash
kernel); the Mamba path is ``models/ssm.py``'s chunked scan.
``loss_fn`` is the next-token cross-entropy; with grad mode on each layer
is recomputed in the backward, as the JAX package's ``jax.checkpoint`` of
its scan body.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C
from repro_torch.models import ssm
from repro_torch.models.attention import (
    Attention,
    chunked_attention,
    decode_attention,
    out_project,
    qkv_project,
)
from repro_torch.models.transformer import cache_alloc_len, window_schedule

SCAN_CHUNK = 64  # the Mamba scan's chunk in prefill


class Block(nn.Module):
    """ln1, attn, mamba (d_inner = d), attn_norm, mamba_norm, ln2, mlp."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = C.RMSNorm(d, device)
        self.attn = Attention(cfg, device)
        self.mamba = ssm.Mamba(d, d, cfg.ssm_state, cfg.conv_kernel,
                               C.param_dtype(cfg), device)
        self.attn_norm = C.RMSNorm(d, device)
        self.mamba_norm = C.RMSNorm(d, device)
        self.ln2 = C.RMSNorm(d, device)
        self.mlp = C.MLP(cfg, device)

    def init_(self, generator) -> None:
        for part in self.children():
            part.init_(generator)


class Hymba(nn.Module):
    """embedding, layers, final_norm."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embedding = C.Embedding(cfg, device)
        self.layers = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = C.RMSNorm(cfg.d_model, device)

    def init_(self, generator) -> None:
        self.embedding.init_(generator)
        for block in self.layers:
            block.init_(generator)
        self.final_norm.init_()


def init_params(generator: torch.Generator, cfg: ModelConfig) -> Hymba:
    """Random weights on the generator's device, in ``cfg.dtype`` (the
    Mamba recurrence's leaves in fp32)."""
    params = Hymba(cfg, generator.device)
    params.init_(generator)
    return params


def _norm(norm, x, cfg: ModelConfig):
    return C.rmsnorm_apply(norm, x, cfg.norm_eps)


def _fuse(block: Block, attn_out, mamba_out, cfg: ModelConfig):
    a = _norm(block.attn_norm, attn_out, cfg)
    m = _norm(block.mamba_norm, mamba_out, cfg)
    return 0.5 * (a + m)


def _mlp(block: Block, x, cfg: ModelConfig):
    return x + C.mlp_apply(block.mlp, _norm(block.ln2, x, cfg))


def _block_forward(block: Block, x, positions, window: int,
                   cfg: ModelConfig):
    """Full-sequence block from a fresh Mamba state: attention ∥ Mamba on
    the same normalised input, fused, then the MLP. x [B, S, d]."""
    h = _norm(block.ln1, x, cfg)
    q, k, v = qkv_project(block.attn, h)
    q = C.apply_rope(q, positions, cfg.rope_theta)
    k = C.apply_rope(k, positions, cfg.rope_theta)
    attn = out_project(block.attn,
                       chunked_attention(q, k, v, window, causal=True))
    mam = ssm.mamba_apply(block.mamba, h, chunk=SCAN_CHUNK)
    return _mlp(block, x + _fuse(block, attn, mam, cfg), cfg)


def forward_hidden(params: Hymba, tokens, cfg: ModelConfig):
    """Final hidden states [B, S, d]; under autograd each layer is
    recomputed in the backward (``common.remat_call``)."""
    x = C.embed_tokens(params.embedding, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    for block, win in zip(params.layers, window_schedule(cfg).tolist()):
        x = C.remat_call(_block_forward, block, x, positions, win, cfg)
    return _norm(params.final_norm, x, cfg)


def loss_fn(params: Hymba, batch: dict, cfg: ModelConfig):
    """Next-token cross-entropy (``repro.models.hymba.loss_fn``). batch:
    tokens [B, S], labels [B, S]."""
    x = forward_hidden(params, batch["tokens"], cfg)
    return C.chunked_xent_loss(params.embedding, x, batch["labels"])


# -- serving: KV cache (attention) and recurrent state (Mamba) -----------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cuda") -> dict:
    """k, v [L, B, S_alloc, Hkv, D] in the model's dtype, kv_pos [B,
    S_alloc], and the Mamba state ssm_h [L, B, d, N] and conv history
    ssm_conv [L, B, k-1, d] in fp32."""
    s_alloc = cache_alloc_len(cfg, seq_len)
    dt = C.param_dtype(cfg)
    l, d = cfg.n_layers, cfg.d_model
    kv = (l, batch, s_alloc, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
        "kv_pos": torch.full((batch, s_alloc), -1, dtype=torch.int32,
                             device=device),
        "ssm_h": torch.zeros((l, batch, d, cfg.ssm_state),
                             dtype=torch.float32, device=device),
        "ssm_conv": torch.zeros((l, batch, cfg.conv_kernel - 1, d),
                                dtype=torch.float32, device=device),
    }


def prefill(params: Hymba, tokens, cfg: ModelConfig, *,
            max_len: int | None = None):
    """Full prompt pass that also keeps each layer's K, V and final Mamba
    state. Returns (last-token logits [B, V] fp32, cache)."""
    x = C.embed_tokens(params.embedding, tokens)
    b, s = tokens.shape
    dev = x.device
    positions = torch.arange(s, device=dev)
    ks, vs, hs, convs = [], [], [], []
    for block, win in zip(params.layers, window_schedule(cfg).tolist()):
        h = _norm(block.ln1, x, cfg)
        q, k, v = qkv_project(block.attn, h)
        q = C.apply_rope(q, positions, cfg.rope_theta)
        k = C.apply_rope(k, positions, cfg.rope_theta)
        attn = out_project(block.attn,
                           chunked_attention(q, k, v, win, causal=True))
        m = block.mamba
        u, z, dtg, bmat, cmat, u_raw = ssm._mamba_gates(m, h)
        h0 = torch.zeros((b, cfg.d_model, cfg.ssm_state), dtype=torch.float32,
                         device=dev)
        y, h_last = ssm._mamba_scan_chunked(u, dtg, bmat, cmat, m.a_log, h0,
                                            SCAN_CHUNK)
        y = (y + u * m.d_skip) * F.silu(z.float())
        x = _mlp(block, x + _fuse(block, attn, y.to(x.dtype) @ m.out_proj,
                                  cfg), cfg)
        ks.append(k)
        vs.append(v)
        hs.append(h_last)
        # the decode conv history is the PRE-conv input (a copy, not a view
        # that keeps the whole projection alive)
        convs.append(u_raw[:, -(cfg.conv_kernel - 1):].float().clone())
    x = _norm(params.final_norm, x, cfg)
    ks, vs = torch.stack(ks), torch.stack(vs)
    s_alloc = cache_alloc_len(cfg, max_len or s)
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
             "ssm_h": torch.stack(hs), "ssm_conv": torch.stack(convs)}
    return C.logits_last(params.embedding, x[:, -1]), cache


def decode_step(params: Hymba, cache: dict, tokens, pos, cfg: ModelConfig):
    """One token a sequence: tokens [B], pos [B] its absolute position.
    The cache is updated in place. Returns (logits [B, V] fp32, cache)."""
    x = C.embed_tokens(params.embedding, tokens[:, None])
    b = tokens.shape[0]
    s_alloc = cache["k"].shape[2]
    slot = (pos % s_alloc).long()
    bidx = torch.arange(b, device=x.device)
    cache["kv_pos"].index_put_((bidx, slot), pos.to(torch.int32))
    windows = window_schedule(cfg).tolist()
    for layer, (block, win) in enumerate(zip(params.layers, windows)):
        kc, vc = cache["k"][layer], cache["v"][layer]
        h = _norm(block.ln1, x, cfg)
        q, k, v = qkv_project(block.attn, h)
        q = C.apply_rope(q, pos[:, None], cfg.rope_theta)
        k = C.apply_rope(k, pos[:, None], cfg.rope_theta)
        kc.index_put_((bidx, slot), k[:, 0])
        vc.index_put_((bidx, slot), v[:, 0])
        attn = out_project(block.attn, decode_attention(
            q, kc, vc, cache["kv_pos"], pos, win))
        mam, new = ssm.mamba_decode_step(
            block.mamba, {"h": cache["ssm_h"][layer],
                          "conv": cache["ssm_conv"][layer]}, h[:, 0])
        cache["ssm_h"][layer] = new["h"]
        cache["ssm_conv"][layer] = new["conv"]
        x = _mlp(block, x + _fuse(block, attn, mam[:, None], cfg), cfg)
    x = _norm(params.final_norm, x, cfg)
    return C.logits_last(params.embedding, x[:, 0]), cache
