"""Public op: paged decode attention, dispatched on the tensors' device.

CUDA tensors go to the hand-written kernel, CPU tensors to its plain
version; there is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from .kernel import check_args, paged_attention_cuda
from .ref import paged_attention_ref


def paged_attention(q, k_pool, v_pool, block_tables, lengths,
                    slot_valid=None):
    """q [B, Hq, D] against the pages of each sequence's block table:
    GQA, ``lengths`` and per-slot ``slot_valid`` masks, fp32 online
    softmax. Returns [B, Hq, D]."""
    if slot_valid is None:
        b, m, p = *block_tables.shape, k_pool.shape[1]
        slot_valid = torch.ones((b, m, p), dtype=torch.int8, device=q.device)
    args = (q, k_pool, v_pool, block_tables, lengths, slot_valid)
    if q.is_cuda:
        return paged_attention_cuda(*args)
    if q.device.type == "cpu":
        check_args(*args)
        return paged_attention_ref(*args)
    raise ValueError(f"paged_attention: no kernel for {q.device}")


__all__ = ["paged_attention", "paged_attention_ref"]
