"""Plain PyTorch version of paged decode attention (as
``repro.kernels.paged_attention.ref``): what runs on the CPU and what the
kernel is held against on the card.

Layout (shared with kvcache/):
    k_pool, v_pool : [n_blocks, page_size, Hkv, D]   the global block pool
    block_tables   : [B, max_pages] int32            per-sequence page list
                     (-1 = unallocated)
    lengths        : [B] int32                       tokens in each sequence
    slot_valid     : [B, max_pages, page_size] int8  0 = eviction hole
    q              : [B, Hq, D]                      one new token per seq
Token t of sequence b lives at pool[block_tables[b, t // page], t % page].
An unallocated page is masked, never indexed: -1 would wrap to the last
block.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pool, v_pool, block_tables, lengths,
                        slot_valid=None):
    b, hq, d = q.shape
    _, p, hkv, _ = k_pool.shape
    m = block_tables.shape[1]
    tables = block_tables.long().clamp(min=0)  # masked below where -1
    k_seq = k_pool[tables].reshape(b, m * p, hkv, d)
    v_seq = v_pool[tables].reshape(b, m * p, hkv, d)
    pos = torch.arange(m * p, device=q.device)
    valid = (pos[None, :] < lengths[:, None]) & (
        (block_tables >= 0).repeat_interleave(p, dim=1))
    if slot_valid is not None:
        valid &= slot_valid.reshape(b, m * p) != 0
    qg = q.reshape(b, hkv, hq // hkv, d).float() * d ** -0.5
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_seq.float())
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", w, v_seq.float())
    return out.reshape(b, hq, d).to(q.dtype)
