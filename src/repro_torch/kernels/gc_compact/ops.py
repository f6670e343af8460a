"""Public ops: GC slot compaction and KV-pool compaction, dispatched on
the tensors' device.

CUDA tensors go to the hand-written kernel, CPU tensors to its plain
version; there is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from .kernel import (
    check_args,
    check_kv_args,
    compact_slots_cuda,
    gc_compact_cuda,
    plan_moves,
)
from .ref import compact_slots_flat, compact_slots_ref, gc_compact_ref


def compact_slots_(slot_lba, valid, src_block, src_slot, dst_block,
                   dst_slot) -> None:
    """In place: apply per-drive move lists [D, M] to the pools slot_lba /
    valid [D, K, B] (see ``kernels/csrc/compact_slots.cu``)."""
    args = (slot_lba, valid, src_block, src_slot, dst_block, dst_slot)
    if slot_lba.is_cuda:
        compact_slots_cuda(*args)  # checks its args
    elif slot_lba.device.type == "cpu":
        check_args(*args)
        compact_slots_flat(*args)
    else:
        raise ValueError(f"compact_slots: no kernel for {slot_lba.device}")


def compact_slots(slot_lba, valid, src_block, src_slot, dst_block, dst_slot):
    """The JAX package's functional signature for one drive: pools [K, B],
    moves [M]. Returns new (slot_lba, valid)."""
    slot_lba, valid = slot_lba.clone(), valid.clone()
    moves = [
        torch.as_tensor(x, device=slot_lba.device).to(torch.int32)[None]
        for x in (src_block, src_slot, dst_block, dst_slot)
    ]
    compact_slots_(slot_lba[None], valid[None], *moves)
    return slot_lba, valid


def gc_compact_(k_pools, v_pools, moves) -> None:
    """In place: apply the host move list [M, 4] int32 (src_block,
    src_slot, dst_block, dst_slot; src_block < 0 = no-op) to every layer
    of the K and V pools [L, N, P, Hkv, D], every read before any write
    (see ``kernels/csrc/gc_compact.cu``). The list is checked on the host
    (``kernel.plan_moves``): a row outside the pool, or two rows with one
    destination, raise."""
    if k_pools.is_cuda:
        gc_compact_cuda(k_pools, v_pools, moves)  # checks its args
    elif k_pools.device.type == "cpu":
        check_kv_args(k_pools, v_pools)
        plan_moves(moves, *k_pools.shape[1:3])
        gc_compact_ref(k_pools, v_pools, moves)
    else:
        raise ValueError(f"gc_compact: no kernel for {k_pools.device}")


__all__ = [
    "compact_slots", "compact_slots_", "compact_slots_flat",
    "compact_slots_ref", "gc_compact_", "gc_compact_ref",
]
