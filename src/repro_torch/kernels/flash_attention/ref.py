"""Plain PyTorch version of the flash-attention kernel: the einsum
attention of ``models.attention.reference_attention`` (as
``repro.kernels.flash_attention.ref``). It is what runs on the CPU and
what the kernel is held against on the card."""

from __future__ import annotations

from repro_torch.models.attention import reference_attention


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] -> [B, Sq, Hq, D]."""
    return reference_attention(q, k, v, causal=causal, window=window)
