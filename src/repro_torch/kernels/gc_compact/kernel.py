"""ctypes bindings of the GC compaction kernels, the ports of the Pallas
TPU kernel in ``repro/kernels/gc_compact/kernel.py`` (``_run``): the
simulator's slot compaction (``kernels/csrc/compact_slots.cu``, reached as
``compact_slots``) and the serving engine's KV-pool compaction
(``kernels/csrc/gc_compact.cu``, reached as ``gc_compact``)."""

from __future__ import annotations

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


# KV-pool compaction (gc_compact): launches since the count was last set to 0
kv_launches = 0


def check_moves(moves, n_blocks: int, page: int) -> None:
    """Raise unless ``moves`` is a host int32 [M, 4] tensor of rows
    (src_block, src_slot, dst_block, dst_slot) whose live rows (src_block
    >= 0) lie inside the pool. The move list is built on the host, so it
    is checked there and no row is skipped silently."""
    if (moves.device.type != "cpu" or moves.dtype != torch.int32
            or moves.dim() != 2 or moves.shape[1] != 4):
        raise ValueError("gc_compact: wants host int32 moves [M, 4], got "
                         f"{moves.dtype} {tuple(moves.shape)} on "
                         f"{moves.device}")
    live = moves[moves[:, 0] >= 0]
    bad = ((live[:, [0, 2]] >= n_blocks) | (live[:, [1, 3]] >= page)).any(1)
    bad |= (live < 0).any(1)
    if bool(bad.any()):
        raise IndexError(f"gc_compact: moves outside a pool of {n_blocks} "
                         f"blocks × {page} slots: {live[bad][:4].tolist()}")


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
    """Launch the gather and the scatter on the current stream; updates the
    pools in place. ``moves`` is the host [M, 4] int32 move list; an empty
    one launches nothing."""
    global kv_launches
    check_kv_args(k_pools, v_pools)
    n_layers, n, p = k_pools.shape[:3]
    check_moves(moves, n, p)
    if not k_pools.is_cuda:
        raise ValueError(f"gc_compact_cuda: tensors on {k_pools.device}")
    row_bytes = k_pools[0, 0, 0].numel() * k_pools.element_size()
    m = moves.shape[0]
    if m == 0:  # nothing to move: no launch, and none counted
        return
    dev_moves = moves.to(k_pools.device)
    scratch = torch.empty(2 * n_layers * m * row_bytes, dtype=torch.uint8,
                          device=k_pools.device)
    fn = _build.launcher("gc_compact")
    err = fn(
        k_pools.data_ptr(), v_pools.data_ptr(), dev_moves.data_ptr(),
        scratch.data_ptr(), n_layers, n, p, m, row_bytes // 16,
        torch.cuda.current_stream(k_pools.device).cuda_stream,
    )
    _build.check_launch("gc_compact", err)
    kv_launches += 1
