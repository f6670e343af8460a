"""Transformer decode on the Wolf-KV paged cache (the counterpart of
``repro.serving.paged_model``).

Shares parameters with ``models.transformer`` (the same module tree), but
each layer's KV lives in the global block pool and decode attention goes
through the paged-attention kernel, which reads Wolf-KV's block tables and
validity masks. This is the device data path of the serving engine; the
host control plane is ``kvcache/manager.py``. A model with
``use_rope=False`` gets no positions at all here: the JAX package's paged
model adds no learned ones. Where the JAX package returns
new pools, the port writes them in place (``index_put_``, and the
gc_compact kernel for compaction) and returns the same dict.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.gc_compact.ops import gc_compact_
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models import common as C
from repro_torch.models.attention import chunked_attention, qkv_project
from repro_torch.models.transformer import (
    Transformer,
    _ffn,
    _norm,
    window_schedule,
)


def init_pools(cfg: ModelConfig, n_blocks: int, page: int,
               device="cuda") -> dict:
    """{"k", "v": [L, N, P, Hkv, D]} zeros in the model's dtype."""
    shape = (cfg.n_layers, n_blocks, page, cfg.n_kv_heads, cfg.d_head)
    dt = C.param_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def paged_decode_step(params: Transformer, cfg: ModelConfig, pools: dict,
                      tables, slot_valid, lengths, write_blk, write_slot,
                      tokens, pos):
    """One decode token per sequence. tables [B, M] int32, slot_valid
    [B, M, P] int8, lengths [B] int32 (the cache length including the new
    token), write_blk / write_slot [B] (where the new token's KV goes),
    tokens [B], pos [B] absolute positions (for RoPE), all on the pools'
    device. Returns (logits [B, V] fp32, pools)."""
    x = C.embed_tokens(params.embedding, tokens[:, None])
    wb, ws = write_blk.long(), write_slot.long()
    for block, k_pool, v_pool in zip(params.layers, pools["k"], pools["v"]):
        h = _norm(block.ln1, x, cfg)
        q, k, v = qkv_project(block.attn, h)
        if cfg.use_rope:
            q = C.apply_rope(q, pos[:, None], cfg.rope_theta)
            k = C.apply_rope(k, pos[:, None], cfg.rope_theta)
        k_pool.index_put_((wb, ws), k[:, 0])
        v_pool.index_put_((wb, ws), v[:, 0])
        attn = paged_attention(q[:, 0], k_pool, v_pool, tables, lengths,
                               slot_valid)
        x = x + torch.einsum("bhk,hkd->bd", attn, block.attn.wo)[:, None]
        x = x + _ffn(block, _norm(block.ln2, x, cfg), cfg)
    x = _norm(params.final_norm, x, cfg)
    return C.logits_last(params.embedding, x[:, 0]), pools


def paged_prefill(params: Transformer, cfg: ModelConfig, pools: dict,
                  tokens, write_blk, write_slot):
    """Prompt pass that writes KV straight into the paged pool. tokens,
    write_blk, write_slot [B, S]. Attention is the plain chunked one: the
    JAX package certifies no static window here, so no kernel runs."""
    b, s = tokens.shape
    x = C.embed_tokens(params.embedding, tokens)
    positions = torch.arange(s, device=x.device)
    wb, ws = write_blk.reshape(-1).long(), write_slot.reshape(-1).long()
    layers = zip(params.layers, pools["k"], pools["v"],
                 window_schedule(cfg).tolist())
    for block, k_pool, v_pool, win in layers:
        h = _norm(block.ln1, x, cfg)
        q, k, v = qkv_project(block.attn, h)
        if cfg.use_rope:
            q = C.apply_rope(q, positions, cfg.rope_theta)
            k = C.apply_rope(k, positions, cfg.rope_theta)
        attn = chunked_attention(q, k, v, win, causal=True)
        x = x + torch.einsum("bshk,hkd->bsd", attn, block.attn.wo)
        x = x + _ffn(block, _norm(block.ln2, x, cfg), cfg)
        k_pool.index_put_((wb, ws), k.reshape(b * s, *k.shape[2:]))
        v_pool.index_put_((wb, ws), v.reshape(b * s, *v.shape[2:]))
    x = _norm(params.final_norm, x, cfg)
    return C.logits_last(params.embedding, x[:, -1]), pools


def apply_moves(pools: dict, moves) -> dict:
    """Run the manager's compaction move list [(src_block, src_slot,
    dst_block, dst_slot), ...] on every layer of the pools, in place (the
    gc_compact kernel on the card)."""
    if moves:
        gc_compact_(pools["k"], pools["v"],
                    torch.tensor(moves, dtype=torch.int32))
    return pools
