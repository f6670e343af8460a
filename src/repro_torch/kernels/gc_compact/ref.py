"""Plain PyTorch versions of the GC slot compaction and of the KV-pool
compaction.

``compact_slots_ref`` is the 2-D gather-then-scatter formulation,
functional, the oracle (as ``repro.kernels.gc_compact.ref.
compact_slots_ref``). ``compact_slots_flat`` is the CUDA kernel's contract
in plain PyTorch: per-drive move lists ``[D, M]`` applied in place to pools
``[D, K, B]``. It is what the simulator runs on the CPU and what the kernel
is held against on the card. Every read happens before any write, so source
and destination slots may interleave. Rows the kernel skips (``src_block <
0``, an index outside the pools) are masked here, never indexed.

``gc_compact_ref`` is the KV kernel's contract and its one plain version
(the counterpart of ``repro.kernels.gc_compact.ref.gc_compact_ref``, which
takes one layer and is run under ``vmap``): one move list applied in place
to every layer of the K and V pools ``[L, N, P, Hkv, D]``, all reads before
any write. That move list comes from the host and is checked there
(``kernel.plan_moves``), so no row is skipped silently.
"""

from __future__ import annotations

import torch


def compact_slots_ref(slot_lba, valid, src_block, src_slot, dst_block,
                      dst_slot):
    """slot_lba [K, B] int32, valid [K, B] bool, moves [M] int32 each (a
    row with src_block < 0 is a no-op). Returns new (slot_lba, valid)."""
    ok = src_block >= 0
    sb, ss = src_block[ok].long(), src_slot[ok].long()
    db, ds = dst_block[ok].long(), dst_slot[ok].long()
    lba_rows = slot_lba[sb, ss]
    valid_rows = valid[sb, ss]
    slot_lba, valid = slot_lba.clone(), valid.clone()
    slot_lba[db, ds] = lba_rows
    valid[db, ds] = valid_rows
    return slot_lba, valid


def compact_slots_flat(slot_lba, valid, src_block, src_slot, dst_block,
                       dst_slot) -> None:
    """In place: slot_lba [D, K, B] int32, valid [D, K, B] bool, moves
    [D, M] int32 each."""
    n_drives, k, b = slot_lba.shape
    sl = slot_lba.view(n_drives, -1)
    va = valid.view(n_drives, -1)
    sb, ss = src_block.long(), src_slot.long()
    db, ds = dst_block.long(), dst_slot.long()
    ok = (
        (sb >= 0) & (sb < k) & (ss >= 0) & (ss < b)
        & (db >= 0) & (db < k) & (ds >= 0) & (ds < b)
    )
    drive = torch.arange(n_drives, device=sb.device)[:, None].expand_as(sb)
    drive, src, dst = drive[ok], (sb * b + ss)[ok], (db * b + ds)[ok]
    lba_rows = sl[drive, src]  # gathers (copies) before any scatter
    valid_rows = va[drive, src]
    sl[drive, dst] = lba_rows
    va[drive, dst] = valid_rows


def gc_compact_ref(k_pools, v_pools, moves) -> None:
    """In place: k_pools / v_pools [L, N, P, Hkv, D]; moves [M, 4] int32
    rows (src_block, src_slot, dst_block, dst_slot), checked on the host."""
    mv = moves[moves[:, 0] >= 0].long().to(k_pools.device)
    for pools in (k_pools, v_pools):
        rows = pools[:, mv[:, 0], mv[:, 1]]  # a gather copies: reads first
        pools[:, mv[:, 2], mv[:, 3]] = rows
