"""ctypes binding of the paged decode-attention kernel
(``kernels/csrc/paged_attention.cu``), the port of the Pallas TPU kernel in
``repro/kernels/paged_attention/kernel.py`` (``paged_attention``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# kernel launches since the count was last set to 0 (one per call below)
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_args(q, k_pool, v_pool, block_tables, lengths, slot_valid) -> None:
    """Raise unless the tensors are what the kernel takes: q [B, Hq, D];
    pools [N, P, Hkv, D] in q's dtype (fp32 or bf16); tables [B, M] int32;
    lengths [B] int32; slot_valid [B, M, P] int8; contiguous, one device."""
    if q.dim() != 3 or k_pool.dim() != 4 or block_tables.dim() != 2:
        raise ValueError(
            "paged_attention: wants q [B, Hq, D], pools [N, P, Hkv, D], "
            f"tables [B, M]; got {tuple(q.shape)}, {tuple(k_pool.shape)}, "
            f"{tuple(block_tables.shape)}")
    b, hq, d = q.shape
    n, p, hkv, _ = k_pool.shape
    m = block_tables.shape[1]
    if q.dtype not in DTYPES or hq % hkv:
        raise ValueError(f"paged_attention: no kernel for {q.dtype}, "
                         f"{hq} query / {hkv} kv heads")
    _build.check_tensors(
        "paged_attention", q=(q, q.dtype, q.shape),
        k_pool=(k_pool, q.dtype, (n, p, hkv, d)),
        v_pool=(v_pool, q.dtype, (n, p, hkv, d)),
        block_tables=(block_tables, torch.int32, (b, m)),
        lengths=(lengths, torch.int32, (b,)),
        slot_valid=(slot_valid, torch.int8, (b, m, p)),
    )


def paged_attention_cuda(q, k_pool, v_pool, block_tables, lengths,
                         slot_valid) -> torch.Tensor:
    """Launch the kernel on the current stream; returns [B, Hq, D]."""
    global launches
    check_args(q, k_pool, v_pool, block_tables, lengths, slot_valid)
    if not q.is_cuda:
        raise ValueError(f"paged_attention_cuda: tensors on {q.device}")
    _build.check_aligned("paged_attention", q=q, k_pool=k_pool,
                         v_pool=v_pool)
    b, hq, d = q.shape
    n, p, hkv, _ = k_pool.shape
    out = torch.empty_like(q)
    if b == 0:  # an empty batch: no launch, and none counted
        return out
    fn = _build.launcher("paged_attention")
    err = fn(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), slot_valid.data_ptr(),
        out.data_ptr(), b, hq, hkv, d, p, block_tables.shape[1],
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check_launch("paged_attention", err)
    launches += 1
    return out
