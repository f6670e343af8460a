"""Gradient compression for data parallelism (the counterpart of
``repro.sharding.gradient``).

* ``compress_tree`` / ``decompress_tree``: a stochastic-rounding int8 (or
  bf16) codec over ``{name: tensor}`` dicts, one scale a leaf, with an
  ERROR-FEEDBACK residual carried beside the optimizer state, so the
  codec's noise does not bias the update.
* ``compressed_all_reduce_mean``: a mean over a process group that
  quantizes before the collective (``compressed_psum``'s counterpart).

Leaves go in sorted-name order, the order in which the JAX package
flattens a dict. The int8 noise, uniform on [-0.5, 0.5), is drawn from an
explicit ``torch.Generator`` on the generator's device and moved to the
leaf's, so a card and the CPU given generators in one state quantize alike.

Error feedback, outside the collective:
    g_eff = g + residual
    q     = quantize(g_eff);  residual = g_eff - dequantize(q)
    g_out = all_reduce(dequantize(q)) / n
"""

from __future__ import annotations

import torch
import torch.distributed as dist

F32 = torch.float32
MODES = ("int8", "bf16", "none")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown compression mode {mode!r}")


def _noise(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Uniform [-0.5, 0.5) of x's shape, fp32, on x's device."""
    u = torch.rand(x.shape, generator=generator, dtype=F32,
                   device=generator.device)
    return (u - 0.5).to(x.device)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b correctly rounded on every device: CUDA divides by a host
    scalar as a product with its reciprocal, which can differ in the last
    bit, so b goes to a's device first."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def _quant_int8(x: torch.Tensor, noise: torch.Tensor):
    """(q int8, scale fp32 scalar): scale = max|x| / 127 (1e-12 / 127 at
    least), q = clip(round(x / scale + noise), -127, 127), ties to
    even."""
    scale = _div(torch.clamp(x.abs().max(), min=1e-12), 127.0)
    y = x / scale
    q = torch.clamp(torch.round(y + noise), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.to(F32) * scale).to(dtype)


def compress_tree(tree: dict, generator: torch.Generator | None, *,
                  mode: str = "int8"):
    """{name: tensor} -> (payload, meta). int8: payload {name: int8} and
    meta {name: fp32 scale}, one noise draw a leaf in sorted-name order;
    bf16: payload {name: bf16}, meta None; none: (tree, None)."""
    _check_mode(mode)
    if mode == "none":
        return tree, None
    if mode == "bf16":
        return {k: v.to(torch.bfloat16) for k, v in tree.items()}, None
    qs, scales = {}, {}
    for k in sorted(tree):
        x = tree[k].to(F32)
        qs[k], scales[k] = _quant_int8(x, _noise(x, generator))
    return qs, scales


def decompress_tree(payload: dict, meta: dict | None, like: dict) -> dict:
    """payload (and meta) -> {name: tensor} in ``like``'s dtypes."""
    if meta is None:  # bf16 / none
        return {k: payload[k].to(v.dtype) for k, v in like.items()}
    return {k: _dequant_int8(payload[k], meta[k], v.dtype)
            for k, v in like.items()}


def error_feedback_step(grads: dict, residual: dict,
                        generator: torch.Generator | None, *,
                        mode: str = "int8"):
    """(grads, residual) -> (the gradients after the lossy wire format,
    the new residual): what the optimizer consumes, and what was lost."""
    _check_mode(mode)
    if mode == "none":
        return grads, residual
    eff = {k: g.to(F32) + residual[k] for k, g in grads.items()}
    payload, meta = compress_tree(eff, generator, mode=mode)
    restored = decompress_tree(payload, meta, eff)
    new_residual = {k: e - restored[k].to(F32) for k, e in eff.items()}
    return restored, new_residual


def init_residual(params: dict) -> dict:
    """fp32 zeros keyed and shaped like ``params``."""
    return {k: torch.zeros(p.shape, dtype=F32, device=p.device)
            for k, p in params.items()}


def _world(group) -> int:
    """The participants: one without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _compressed_mean(x: torch.Tensor, noise, *, group=None,
                     mode: str = "int8") -> torch.Tensor:
    """``compressed_all_reduce_mean`` with its noise given."""
    _check_mode(mode)
    n = _world(group)
    if mode == "none":
        total = x.clone()
        if n > 1:
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return _div(total, n)
    q, scale = _quant_int8(x.to(F32), noise)
    # contributions have different scales: reduce in a common one
    s_max = scale.clone()
    if n > 1:
        dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
    rescaled = (q.to(F32) * (scale / s_max)).to(F32)
    if n > 1:
        dist.all_reduce(rescaled, op=dist.ReduceOp.SUM, group=group)
    return _div(rescaled * s_max, n).to(x.dtype)


def compressed_all_reduce_mean(x: torch.Tensor,
                               generator: torch.Generator | None, *,
                               group=None, mode: str = "int8"):
    """Mean of ``x`` over ``group`` (the default group; without one, a
    single participant, as a ``psum`` over an axis of size 1): each
    participant quantizes its contribution to int8 with its own noise,
    the scales are reduced by MAX and the payloads, rescaled to it, by
    SUM. Any mode but "none" goes through int8, as ``compressed_psum``
    does."""
    noise = None if mode == "none" else _noise(x, generator)
    return _compressed_mean(x, noise, group=group, mode=mode)
