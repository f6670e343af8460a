"""ctypes bindings of the GC compaction kernels, the ports of the Pallas
TPU kernel in ``repro/kernels/gc_compact/kernel.py`` (``_run``): the
simulator's slot compaction (``kernels/csrc/compact_slots.cu``, reached as
``compact_slots``) and the serving engine's KV-pool compaction
(``kernels/csrc/gc_compact.cu``, reached as ``gc_compact``)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

# compact_slots launches since the count was last set to 0 (one per call)
launches = 0


def check_args(slot_lba, valid, src_block, src_slot, dst_block,
               dst_slot) -> None:
    """Raise unless the tensors are what the kernel takes: slot_lba
    [D, K, B] int32, valid [D, K, B] bool, four [D, M] int32 move columns,
    contiguous, on one device, D >= 1."""
    if slot_lba.dim() != 3 or slot_lba.shape[0] < 1 or src_block.dim() != 2:
        raise ValueError(
            "compact_slots: wants pools [D, K, B] and moves [D, M], got "
            f"{tuple(slot_lba.shape)} and {tuple(src_block.shape)}"
        )
    moves = (slot_lba.shape[0], src_block.shape[1])
    _build.check_tensors(
        "compact_slots",
        slot_lba=(slot_lba, torch.int32, slot_lba.shape),
        valid=(valid, torch.bool, slot_lba.shape),
        src_block=(src_block, torch.int32, moves),
        src_slot=(src_slot, torch.int32, moves),
        dst_block=(dst_block, torch.int32, moves),
        dst_slot=(dst_slot, torch.int32, moves),
    )


def compact_slots_cuda(slot_lba, valid, src_block, src_slot, dst_block,
                       dst_slot) -> None:
    """Launch the kernel on the current stream; updates the pools in place."""
    global launches
    check_args(slot_lba, valid, src_block, src_slot, dst_block, dst_slot)
    if not slot_lba.is_cuda:
        raise ValueError(f"compact_slots_cuda: tensors on {slot_lba.device}")
    fn = _build.launcher("compact_slots")
    n_drives, k, b = slot_lba.shape
    err = fn(
        slot_lba.data_ptr(), valid.data_ptr(), src_block.data_ptr(),
        src_slot.data_ptr(), dst_block.data_ptr(), dst_slot.data_ptr(),
        n_drives, src_block.shape[1], k, b,
        torch.cuda.current_stream(slot_lba.device).cuda_stream,
    )
    _build.check_launch("compact_slots", err)
    launches += 1


# KV-pool compaction (gc_compact): calls that launched since the count was
# last set to 0, and the device launches they made (1, or 2 with hazards)
kv_launches = 0
kv_device_launches = 0


def plan_moves(moves, n_blocks: int, page: int):
    """One numpy pass over the host move list: check it and plan the copy.

    ``moves`` is a host int32 [M, 4] tensor of rows (src_block, src_slot,
    dst_block, dst_slot); a row with src_block < 0 is a no-op and is
    dropped. Raises unless every live row lies inside the pool of
    ``n_blocks`` × ``page`` slots (the list is built on the host and
    checked there, so no row is skipped silently), and on two live rows
    with one destination: under the gather-then-scatter contract they have
    no order, and the block manager never makes them. Returns (rows,
    n_hazard): the live rows as an int32 [m, 4] array with the n_hazard
    hazard rows first, the rows whose source slot is some row's
    destination. Only those must be read before the copy writes."""
    if (moves.device.type != "cpu" or moves.dtype != torch.int32
            or moves.dim() != 2 or moves.shape[1] != 4):
        raise ValueError("gc_compact: wants host int32 moves [M, 4], got "
                         f"{moves.dtype} {tuple(moves.shape)} on "
                         f"{moves.device}")
    mv = moves.numpy()
    keep = mv[:, 0] >= 0
    live = mv if keep.all() else mv.compress(keep, axis=0)
    if len(live) == 0:
        return live, 0
    blk, slot = live[:, 0::2], live[:, 1::2]  # (src, dst) columns
    if (live.min() < 0 or blk.max() >= n_blocks or slot.max() >= page):
        bad = ((blk >= n_blocks) | (slot >= page)).any(1)
        bad |= (live < 0).any(1)
        raise IndexError(f"gc_compact: moves outside a pool of {n_blocks} "
                         f"blocks × {page} slots: {live[bad][:4].tolist()}")
    flat = blk.astype(np.int64) * page + slot  # [m, 2] slot indices
    lands = np.bincount(flat[:, 1], minlength=n_blocks * page)
    if lands.max() > 1:
        twice = [divmod(int(f), page) for f in np.flatnonzero(lands > 1)[:4]]
        raise ValueError("gc_compact: two moves land on one slot "
                         f"(block, slot): {twice}")
    hazard = lands[flat[:, 0]] > 0
    n_hazard = int(np.count_nonzero(hazard))
    if n_hazard:  # hazard rows first, each part in list order
        live = live.take(np.argsort(~hazard, kind="stable"), axis=0)
    return np.ascontiguousarray(live), n_hazard


def check_kv_args(k_pools, v_pools) -> None:
    """Raise unless the pools are [L, N, P, Hkv, D], one dtype, contiguous,
    on one device, with a token slot a whole number of 16-byte vectors."""
    if k_pools.dim() != 5:
        raise ValueError("gc_compact: wants pools [L, N, P, Hkv, D], got "
                         f"{tuple(k_pools.shape)}")
    _build.check_tensors(
        "gc_compact", k_pools=(k_pools, k_pools.dtype, k_pools.shape),
        v_pools=(v_pools, k_pools.dtype, k_pools.shape),
    )
    row_bytes = k_pools[0, 0, 0].numel() * k_pools.element_size()
    if row_bytes % 16:
        raise ValueError(f"gc_compact: a token slot of {row_bytes} bytes "
                         "is not a whole number of 16-byte vectors")


def gc_compact_cuda(k_pools, v_pools, moves) -> None:
    """Plan the host move list [M, 4] int32 (:func:`plan_moves`), upload
    the planned rows from pinned memory without waiting, and launch the
    copy on the current stream (two launches when some row's source is
    another's destination); updates the pools in place. A list without a
    live row launches nothing."""
    global kv_launches, kv_device_launches
    check_kv_args(k_pools, v_pools)
    n_layers, n, p = k_pools.shape[:3]
    rows, n_hazard = plan_moves(moves, n, p)
    if not k_pools.is_cuda:
        raise ValueError(f"gc_compact_cuda: tensors on {k_pools.device}")
    m = len(rows)
    if m == 0:  # nothing to move: no launch, and none counted
        return
    row_vecs = k_pools[0, 0, 0].numel() * k_pools.element_size() // 16
    pinned = torch.empty((m, 4), dtype=torch.int32, pin_memory=True)
    pinned.numpy()[:] = rows
    # the pinned block is held by the caching host allocator until the
    # copy it was queued for has run
    dev_rows = pinned.to(k_pools.device, non_blocking=True)
    scratch = (torch.empty(2 * n_layers * n_hazard * row_vecs * 16,
                           dtype=torch.uint8, device=k_pools.device)
               if n_hazard else None)
    fn = _build.launcher("gc_compact")
    err = fn(
        k_pools.data_ptr(), v_pools.data_ptr(), dev_rows.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n_layers, n, p, m,
        n_hazard, row_vecs,
        torch.cuda.current_stream(k_pools.device).cuda_stream,
    )
    _build.check_launch("gc_compact", err)
    kv_launches += 1
    kv_device_launches += 1 + (n_hazard > 0)
