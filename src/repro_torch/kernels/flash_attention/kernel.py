"""ctypes binding of the flash-attention kernel
(``kernels/csrc/flash_attention.cu``), the port of the Pallas TPU kernel in
``repro/kernels/flash_attention/kernel.py`` (``flash_attention``): bf16 runs
on the tensor cores, fp32 on the CUDA cores in full fp32."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

# kernel launches since the count was last set to 0 (one per call below)
launches = 0

D_HEADS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_args(q, k, v) -> None:
    """Raise unless q [B, Sq, Hq, D] and k / v [B, Skv, Hkv, D] are what
    the kernel takes: one dtype of fp32 / bf16, D in (32, 64, 128), Hq a
    multiple of Hkv, contiguous, on one device."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: wants q [B, Sq, Hq, D] and "
                         f"k/v [B, Skv, Hkv, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES or d not in D_HEADS or hq % hkv:
        raise ValueError(f"flash_attention: no kernel for {q.dtype}, "
                         f"d_head {d}, {hq} query / {hkv} kv heads")
    if sq < 1 or skv < 1:
        raise ValueError("flash_attention: empty sequence")
    _build.check_tensors(
        "flash_attention", q=(q, q.dtype, q.shape),
        k=(k, q.dtype, (b, skv, hkv, d)), v=(v, q.dtype, (b, skv, hkv, d)),
    )


def scored_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the kernel scores: query i sees keys j < skv
    with j <= i when causal (top-left aligned) and j > i - window when
    window > 0."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(i - int(window) + 1, 0) if window > 0 else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def cost(q, k, causal: bool = True, window: int = 0) -> tuple[int, int]:
    """(flops, bytes) of one call on q [B, Sq, Hq, D] and k [B, Skv, Hkv,
    D]: the scored pairs' two products (Q·K and P·V), 2 flops a
    multiply-add; q, k and v read once and the output written once."""
    b, sq, hq, d = q.shape
    flops = 4 * b * hq * d * scored_pairs(sq, k.shape[1], causal, window)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return flops, nbytes


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Launch the kernel on the current stream; returns [B, Sq, Hq, D].
    The kernel has no backward: with grad mode on, inputs that require a
    gradient are refused (``ops.flash_attention`` wraps it in an
    ``autograd.Function`` for them), so no gradient is cut silently."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_cuda: inputs require a gradient; "
                           "call ops.flash_attention, which carries it")
    check_args(q, k, v)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_cuda: tensors on {q.device}")
    _build.check_aligned("flash_attention", q=q, k=k, v=v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if b == 0:  # an empty batch: no launch, and none counted
        return out
    fn = _build.launcher("flash_attention")
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, skv, hq, hkv, d, DTYPES[q.dtype], int(causal), int(window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check_launch("flash_attention", err)
    launches += 1
    return out
