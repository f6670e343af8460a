"""Public ops: the fused fast-path write and the TRIM, dispatched on the
tensors' device.

CUDA tensors go to the hand-written kernel, CPU tensors to its plain
version; there is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from .kernel import (
    apply_trim_cuda,
    apply_write_cuda,
    check_args,
    check_trim_args,
)
from .ref import (
    apply_trim_flat,
    apply_trim_ref,
    apply_write_flat,
    apply_write_ref,
)


def apply_write_(rows, page_map, slot_lba, valid) -> None:
    """In place: land op rows [D, 4] ``(lba, old_pm, new_pm, ok)`` on the
    pools page_map [D, LBA], slot_lba / valid [D, K, B] (see
    ``kernels/csrc/apply_write.cu`` for the contract)."""
    if rows.is_cuda:
        apply_write_cuda(rows, page_map, slot_lba, valid)  # checks its args
    elif rows.device.type == "cpu":
        check_args(rows, page_map, slot_lba, valid)
        apply_write_flat(rows, page_map, slot_lba, valid)
    else:
        raise ValueError(f"apply_write: no kernel for {rows.device}")


def apply_write(page_map, slot_lba, valid, lba, old_pm, dst_blk, dst_slot):
    """The JAX package's functional signature for one drive: page_map
    [LBA], slot_lba / valid [K, B], scalar (lba, old_pm, dst_blk,
    dst_slot). Returns new (page_map, slot_lba, valid)."""
    b = slot_lba.shape[1]
    dev = page_map.device

    def scalar(x):
        return torch.as_tensor(x, device=dev).to(torch.int32).reshape(())

    row = torch.stack([
        scalar(lba), scalar(old_pm),
        scalar(dst_blk) * b + scalar(dst_slot), scalar(1),
    ]).reshape(1, 4)
    page_map, slot_lba, valid = page_map.clone(), slot_lba.clone(), valid.clone()
    apply_write_(row, page_map[None], slot_lba[None], valid[None])
    return page_map, slot_lba, valid


def apply_trim_(rows, page_map, valid) -> None:
    """In place: land TRIM rows [D, 3] ``(lba, old_pm, ok)`` on the pools
    page_map [D, LBA] and valid [D, K, B] (see ``kernels/csrc/
    apply_trim.cu`` for the contract)."""
    if rows.is_cuda:
        apply_trim_cuda(rows, page_map, valid)  # checks its args
    elif rows.device.type == "cpu":
        check_trim_args(rows, page_map, valid)
        apply_trim_flat(rows, page_map, valid)
    else:
        raise ValueError(f"apply_trim: no kernel for {rows.device}")


def apply_trim(page_map, valid, lba, old_pm):
    """The JAX package's functional signature for one drive: page_map
    [LBA], valid [K, B], scalar (lba, old_pm). Returns new (page_map,
    valid)."""
    dev = page_map.device
    row = torch.stack([
        torch.as_tensor(x, device=dev).to(torch.int32).reshape(())
        for x in (lba, old_pm, 1)
    ]).reshape(1, 3)
    page_map, valid = page_map.clone(), valid.clone()
    apply_trim_(row, page_map[None], valid[None])
    return page_map, valid


__all__ = [
    "apply_trim", "apply_trim_", "apply_trim_flat", "apply_trim_ref",
    "apply_write", "apply_write_", "apply_write_flat", "apply_write_ref",
]
