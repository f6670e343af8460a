"""Plain PyTorch versions of the fused fast-path write.

``apply_write_ref`` is the obvious 2-D formulation, functional, the oracle
(as ``repro.kernels.write_path.ref.apply_write_ref``). ``apply_write_flat``
is the CUDA kernel's contract in plain PyTorch: op rows ``[D, 4]`` of
``(lba, old_pm, new_pm, ok)`` land in place on flat per-drive pools. It is
what the simulator runs on the CPU and what the kernel is held against on
the card. Rows the kernel skips (``ok == 0``, ``old_pm < 0``, an index
outside the pools) are masked here, never indexed: PyTorch has no
``mode="drop"``, and ``-1`` would wrap to the last element.
"""

from __future__ import annotations

import torch


def apply_write_ref(page_map, slot_lba, valid, lba, old_pm, dst_blk,
                    dst_slot):
    """Invalidate ``old_pm`` and land ``lba`` at ``(dst_blk, dst_slot)``.

    page_map [LBA] int32, slot_lba [K, B] int32, valid [K, B] bool; the
    scalars are ints or 0-d tensors. The destination is a fresh slot above
    the block's fill pointer, never the old slot, so the clear and the set
    commute. Returns new (page_map, slot_lba, valid).
    """
    b = slot_lba.shape[1]
    lba, old_pm = int(lba), int(old_pm)
    dst_blk, dst_slot = int(dst_blk), int(dst_slot)
    page_map, slot_lba, valid = page_map.clone(), slot_lba.clone(), valid.clone()
    if old_pm >= 0:
        valid[old_pm // b, old_pm % b] = False
    slot_lba[dst_blk, dst_slot] = lba
    valid[dst_blk, dst_slot] = True
    page_map[lba] = dst_blk * b + dst_slot
    return page_map, slot_lba, valid


def apply_write_flat(rows, page_map, slot_lba, valid) -> None:
    """In place: rows [D, 4] int32, page_map [D, LBA] int32, slot_lba
    [D, K, B] int32, valid [D, K, B] bool."""
    n_drives, lba_pages = page_map.shape
    sl = slot_lba.view(n_drives, -1)
    va = valid.view(n_drives, -1)
    slots = sl.shape[1]
    drive = torch.arange(n_drives, device=rows.device)
    lba, old, new, ok = rows.long().unbind(1)
    ok = ok != 0
    clear = ok & (old >= 0) & (old < slots)
    va[drive[clear], old[clear]] = False
    put = ok & (new >= 0) & (new < slots) & (lba >= 0) & (lba < lba_pages)
    d, new, lba = drive[put], new[put], lba[put]
    va[d, new] = True
    sl[d, new] = lba.to(torch.int32)
    page_map[d, lba] = new.to(torch.int32)
