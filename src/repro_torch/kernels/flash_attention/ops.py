"""Public op: flash attention forward, dispatched on the tensors' device.

CUDA tensors go to the hand-written kernel, CPU tensors to its plain
version; there is no fallback from one to the other.
"""

from __future__ import annotations

from .kernel import check_args, flash_attention_cuda
from .ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] -> [B, Sq, Hq, D]: GQA,
    causal (top-left aligned) and sliding-window masks, fp32 softmax."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        check_args(q, k, v)
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention: no kernel for {q.device}")


__all__ = ["flash_attention", "flash_attention_ref"]
