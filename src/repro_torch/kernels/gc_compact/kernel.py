"""ctypes binding of the GC slot-compaction kernel
(``kernels/csrc/compact_slots.cu``), the port of the Pallas TPU kernel in
``repro/kernels/gc_compact/kernel.py`` (``compact_slots``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# kernel launches since the count was last set to 0 (one per call below)
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
