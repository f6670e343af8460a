"""Plain PyTorch versions of the fused fast-path write and TRIM.

``apply_write_ref`` and ``apply_trim_ref`` are the obvious 2-D
formulations, functional, the oracles (as ``repro.kernels.write_path.ref``'s
functions of the same names). ``apply_write_flat`` and ``apply_trim_flat``
are the CUDA kernels' contracts in plain PyTorch: op rows ``[D, 4]`` of
``(lba, old_pm, new_pm, ok)`` or ``[D, 3]`` of ``(lba, old_pm, ok)`` land
in place on flat per-drive pools. They are what the simulator runs on the
CPU and what the kernels are held against on the card. Rows the kernels
skip (``ok == 0``, ``old_pm < 0``, an index outside the pools) are masked
here, never indexed: PyTorch has no ``mode="drop"``, and ``-1`` would wrap
to the last element.
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


def apply_trim_ref(page_map, valid, lba, old_pm):
    """Unmap ``lba`` and clear its old slot ``old_pm`` (``-1``: the page
    was not mapped, and only the map store lands, over the ``-1`` already
    there).

    page_map [LBA] int32, valid [K, B] bool; the scalars are ints or 0-d
    tensors. Returns new (page_map, valid).
    """
    b = valid.shape[1]
    lba, old_pm = int(lba), int(old_pm)
    page_map, valid = page_map.clone(), valid.clone()
    if old_pm >= 0:
        valid[old_pm // b, old_pm % b] = False
    page_map[lba] = -1
    return page_map, valid


def apply_trim_flat(rows, page_map, valid) -> None:
    """In place: rows [D, 3] int32, page_map [D, LBA] int32, valid
    [D, K, B] bool."""
    n_drives, lba_pages = page_map.shape
    va = valid.view(n_drives, -1)
    slots = va.shape[1]
    drive = torch.arange(n_drives, device=rows.device)
    lba, old, ok = rows.long().unbind(1)
    ok = ok != 0
    clear = ok & (old >= 0) & (old < slots)
    va[drive[clear], old[clear]] = False
    unmap = ok & (lba >= 0) & (lba < lba_pages)
    page_map[drive[unmap], lba[unmap]] = -1
