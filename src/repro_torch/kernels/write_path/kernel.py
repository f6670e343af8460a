"""ctypes bindings of the fused fast-path write kernel
(``kernels/csrc/apply_write.cu``) and the TRIM kernel
(``kernels/csrc/apply_trim.cu``), the ports of the Pallas TPU kernels in
``repro/kernels/write_path/kernel.py``."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# kernel launches since the count was last set to 0, one per call of
# apply_write_cuda (``launches``) and of apply_trim_cuda (``trim_launches``)
launches = 0
trim_launches = 0


def check_args(rows, page_map, slot_lba, valid) -> None:
    """Raise unless the tensors are what the kernel takes: rows [D, 4]
    int32, page_map [D, LBA] int32, slot_lba [D, K, B] int32 and valid
    [D, K, B] bool, contiguous, on one device, D >= 1."""
    if page_map.dim() != 2 or slot_lba.dim() != 3 or page_map.shape[0] < 1:
        raise ValueError(
            "apply_write: wants page_map [D, LBA] and slot_lba [D, K, B], "
            f"got {tuple(page_map.shape)} and {tuple(slot_lba.shape)}"
        )
    d = page_map.shape[0]
    _build.check_tensors(
        "apply_write",
        rows=(rows, torch.int32, (d, 4)),
        page_map=(page_map, torch.int32, page_map.shape),
        slot_lba=(slot_lba, torch.int32, (d, *slot_lba.shape[1:])),
        valid=(valid, torch.bool, slot_lba.shape),
    )


def apply_write_cuda(rows, page_map, slot_lba, valid) -> None:
    """Launch the kernel on the current stream; updates the pools in place."""
    global launches
    check_args(rows, page_map, slot_lba, valid)
    if not rows.is_cuda:
        raise ValueError(f"apply_write_cuda: tensors on {rows.device}")
    fn = _build.launcher("apply_write")
    n_drives, lba_pages = page_map.shape
    err = fn(
        rows.data_ptr(), page_map.data_ptr(), slot_lba.data_ptr(),
        valid.data_ptr(), n_drives, lba_pages,
        slot_lba.shape[1] * slot_lba.shape[2],
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    _build.check_launch("apply_write", err)
    launches += 1


def check_trim_args(rows, page_map, valid) -> None:
    """Raise unless the tensors are what the TRIM kernel takes: rows
    [D, 3] int32, page_map [D, LBA] int32 and valid [D, K, B] bool,
    contiguous, on one device, D >= 1."""
    if page_map.dim() != 2 or valid.dim() != 3 or page_map.shape[0] < 1:
        raise ValueError(
            "apply_trim: wants page_map [D, LBA] and valid [D, K, B], "
            f"got {tuple(page_map.shape)} and {tuple(valid.shape)}"
        )
    d = page_map.shape[0]
    _build.check_tensors(
        "apply_trim",
        rows=(rows, torch.int32, (d, 3)),
        page_map=(page_map, torch.int32, page_map.shape),
        valid=(valid, torch.bool, (d, *valid.shape[1:])),
    )


def apply_trim_cuda(rows, page_map, valid) -> None:
    """Launch the TRIM kernel on the current stream; updates the pools in
    place."""
    global trim_launches
    check_trim_args(rows, page_map, valid)
    if not rows.is_cuda:
        raise ValueError(f"apply_trim_cuda: tensors on {rows.device}")
    fn = _build.launcher("apply_trim")
    n_drives, lba_pages = page_map.shape
    err = fn(
        rows.data_ptr(), page_map.data_ptr(), valid.data_ptr(), n_drives,
        lba_pages, valid.shape[1] * valid.shape[2],
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    _build.check_launch("apply_trim", err)
    trim_launches += 1
