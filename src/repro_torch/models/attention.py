"""Attention: chunked online-softmax attention, the flash kernel's call
site, single-token decode attention, and the GQA projection block (the
counterpart of ``repro.models.attention``).

* ``chunked_attention`` is the plain online-softmax attention over KV
  chunks with fp32 accumulators; it never materialises the [Sq, Skv]
  score matrix. On a CUDA tensor with a static window (``window_static >=
  0``) and more than one query it calls the hand-written flash kernel
  (``kernels/flash_attention``), as the JAX package routes to its Pallas
  kernel (repro/models/attention.py:114); a meta tensor takes the same
  route, so an op count on meta sees what the card runs. The tensors'
  device decides: no global switch.
* GQA folds the query heads into [kv_heads, group]; K/V are never repeated.
* Windows are plain integers per layer (0 = full attention).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import _param, dense_init, param_dtype

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int,
          causal: bool) -> torch.Tensor:
    """[Sq, Skv] boolean mask (True = attend); negative kv positions mark
    invalid slots."""
    q, k = q_pos[:, None], kv_pos[None, :]
    ok = k >= 0
    if causal:
        ok = ok & (k <= q)
    if int(window) > 0:
        ok = ok & (k > q - int(window))
    return ok


def reference_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain einsum attention, the oracle. q [B, Sq, Hq, D], k/v [B, Skv,
    Hkv, D]; fp32 inside, returns q's dtype."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d ** -0.5
    dev = q.device
    m = _mask(torch.arange(sq, device=dev), torch.arange(skv, device=dev),
              window, causal)
    scores = torch.where(m, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def chunked_attention(q, k, v, window, *, causal: bool = True,
                      kv_chunk: int = 1024, window_static: int = -1):
    """Online-softmax attention over KV chunks, fp32 accumulators.

    q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D]. ``window_static >= 0``
    certifies that ``window`` equals it; with it, a CUDA (or meta) tensor
    and Sq > 1 the flash kernel runs instead."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if window_static >= 0 and sq > 1 and (q.is_cuda or q.is_meta):
        from repro_torch.kernels.flash_attention.ops import flash_attention

        return flash_attention(q, k, v, causal=causal, window=window_static)
    kv_chunk = min(kv_chunk, skv)
    # K/V are read in their stored dtype; only the small score tensor is
    # upcast for the softmax (as the JAX package does)
    qg = (q.reshape(b, sq, hkv, g, d) * d ** -0.5).to(q.dtype)
    q_pos = torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), device=q.device)
    for lo in range(0, skv, kv_chunk):
        kc, vc = k[:, lo:lo + kv_chunk], v[:, lo:lo + kv_chunk]
        kv_pos = torch.arange(lo, lo + kc.shape[1], device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc).float()
        s = torch.where(_mask(q_pos, kv_pos, window, causal), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vc.dtype), vc)
        acc = acc * alpha[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_pos, pos, window):
    """One decode step against a (possibly ring-buffered) KV cache.

    q [B, 1, Hq, D]; caches [B, S, Hkv, D]; kv_pos [B, S] absolute position
    per slot (-1 invalid); pos [B]; window an int (0 = full). fp32
    softmax."""
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d) * d ** -0.5
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).float()
    ok = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    if int(window) > 0:
        ok = ok & (kv_pos > pos[:, None] - int(window))
    scores = torch.where(ok[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, hq, d).to(q.dtype)


# -- the attention parameter block (QKV + output projection), GQA-aware --------

class Attention(nn.Module):
    """wq [d, Hq, D], wk / wv [d, Hkv, D], wo [Hq, D, d]."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, dh, dt = cfg.d_model, cfg.d_head, param_dtype(cfg)
        self.wq = _param((d, cfg.n_heads, dh), dt, device)
        self.wk = _param((d, cfg.n_kv_heads, dh), dt, device)
        self.wv = _param((d, cfg.n_kv_heads, dh), dt, device)
        self.wo = _param((cfg.n_heads, dh, d), dt, device)

    def init_(self, generator) -> None:
        for t in self.parameters():
            dense_init(t, generator)


def attn_init(cfg: ModelConfig, generator) -> Attention:
    attn = Attention(cfg, generator.device)
    attn.init_(generator)
    return attn


def qkv_project(attn: Attention, x: torch.Tensor):
    """x [B, S, d] -> q [B, S, Hq, D], k / v [B, S, Hkv, D]."""
    q = torch.einsum("bsd,dhk->bshk", x, attn.wq)
    k = torch.einsum("bsd,dhk->bshk", x, attn.wk)
    v = torch.einsum("bsd,dhk->bshk", x, attn.wv)
    return q, k, v


def out_project(attn: Attention, attn_out: torch.Tensor) -> torch.Tensor:
    """[B, S, Hq, D] -> [B, S, d]."""
    return torch.einsum("bshk,hkd->bsd", attn_out, attn.wo)
