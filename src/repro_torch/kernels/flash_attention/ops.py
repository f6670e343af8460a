"""Public op: flash attention forward, dispatched on the tensors' device.

CUDA tensors go to the hand-written kernel, CPU tensors to its plain
version; there is no fallback from one to the other. Meta tensors take
the kernel's route: an empty output, and the kernel's cost recorded.

Under autograd (grad mode on and an input that requires a gradient) the
call is a ``torch.autograd.Function``: the forward is the same dispatch,
and the backward recomputes the attention through the plain
``chunked_attention`` arithmetic and differentiates that. The JAX package
has no backward kernel for its Pallas kernel: its gradients are those of
its plain chunked attention (repro/models/attention.py:114-124), whose
chunk body it rematerialises (``jax.checkpoint``, :165).
"""

from __future__ import annotations

import torch

from repro_torch.utils import opcount

from .kernel import check_args, cost, flash_attention_cuda
from .ref import flash_attention_ref


def _forward(q, k, v, causal: bool, window: int):
    """The card's kernel, or its plain version on the CPU. A meta tensor
    takes the card's route, which the kernel's cost formula records in
    an op count (``utils.opcount``) as it does on the card."""
    if q.is_cuda or q.is_meta:
        opcount.record_kernel("flash_attention",
                              *cost(q, k, causal, window))
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    if q.is_meta:
        check_args(q, k, v)
        return torch.empty_like(q)
    if q.device.type == "cpu":
        check_args(q, k, v)
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention: no kernel for {q.device}")


class FlashAttention(torch.autograd.Function):
    """The flash forward with the plain attention's gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad_out):
        from repro_torch.models.attention import chunked_attention

        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        # a named range, so a profile can tell the recompute's share
        with torch.enable_grad(), torch.profiler.record_function(
                "flash_attention.backward"):
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(saved, need)]
            out = chunked_attention(*inputs, ctx.window, causal=ctx.causal)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (*(next(grads) if n else None for n in need), None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] -> [B, Sq, Hq, D]: GQA,
    causal (top-left aligned) and sliding-window masks, fp32 softmax."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, int(window))
    return _forward(q, k, v, causal, window)


__all__ = ["FlashAttention", "flash_attention", "flash_attention_ref"]
