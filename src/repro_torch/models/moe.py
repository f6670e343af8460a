"""Mixture-of-experts FFN (the counterpart of ``repro.models.moe``):
olmoe-1b-7b (64 experts, top-8) and mixtral-8x22b (8 experts, top-2).

Two implementations, chosen by ``moe_apply(..., impl=)``:

* ``capacity`` (the default) — GShard style: each group of
  ``tokens_per_group`` tokens gives every expert a buffer of ``C = tpg ·
  top_k / E · capacity_factor`` slots, and a (token, choice) past its
  expert's capacity is dropped (its residual passes through). Priority is
  choice-major: every token's first choice comes before any token's
  second. Where the JAX package builds one-hot dispatch and combine
  tensors [g, t, E, C], this module scatters the kept tokens into an
  [E, g·C, d] buffer by index and gathers the experts' outputs back: the
  same function, with no [g, t, E, C] tensor.
* ``dense`` — every expert processes every token, combined with the
  top-k gates: exact, no drops. A call with one token a sequence (every
  decode step) always takes it.

The JAX package switches with a module global (``MOE_IMPL``); here it is
a keyword, so no caller changes process state. The expert products are
plain batched matmuls, as the JAX package's einsums run outside any
Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import _param, dense_init, param_dtype

IMPLS = ("capacity", "dense")


def tokens_per_group(cfg: ModelConfig, total_tokens: int) -> int:
    base = 256 if cfg.top_k > 4 else 1024
    return min(base, total_tokens)


def capacity(cfg: ModelConfig, tpg: int) -> int:
    """Slots a group gives each expert (a float truncated, as written in
    the JAX package)."""
    return max(1, int(tpg * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


class MoE(nn.Module):
    """router [d, E] in fp32 whatever the model's dtype; wi_gate / wi_up
    [E, d, f] and wo [E, f, d] in the model's dtype."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = param_dtype(cfg)
        self.router = _param((d, e), torch.float32, device)
        self.wi_gate = _param((e, d, f), dt, device)
        self.wi_up = _param((e, d, f), dt, device)
        self.wo = _param((e, f, d), dt, device)

    def init_(self, generator) -> None:
        dense_init(self.router, generator)
        for t in (self.wi_gate, self.wi_up, self.wo):  # fan-in on axis 1
            dense_init(t, generator, in_axis=1)


def _router(moe: MoE, x2d, cfg: ModelConfig):
    """x2d [T, d] -> (gates [T, k] fp32, idx [T, k] int64). A stable sort
    breaks ties toward the lower expert, as ``lax.top_k`` does
    (``torch.topk`` promises no order)."""
    logits = x2d.float() @ moe.router  # [T, E]
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :cfg.top_k], dim=-1)  # over the chosen
    return gates, idx[:, :cfg.top_k]


def _expert_ffn(moe: MoE, xe):
    """xe [E, n, d] -> [E, n, d] through each expert's SwiGLU."""
    h = F.silu(torch.matmul(xe, moe.wi_gate)) * torch.matmul(xe, moe.wi_up)
    return torch.matmul(h, moe.wo)


def _combine(ye_sel, weights, dtype):
    """sum_j weights[..., j] · ye_sel[..., j, :], accumulated in fp32 and
    rounded once to ``dtype`` (the JAX package's combine einsum)."""
    return (weights.to(dtype).float()[..., None]
            * ye_sel.float()).sum(-2).to(dtype)


def capacity_from_routing(moe: MoE, x, gates, idx, cfg: ModelConfig):
    """The capacity path after the router: x [B, S, d], gates [T, k] fp32
    and idx [T, k] (T = B·S). Returns (out [B, S, d], keep [T, k] bool:
    the (token, choice) pairs that found a slot)."""
    b, s, d = x.shape
    t_total = b * s
    k, e = cfg.top_k, cfg.n_experts
    tpg = tokens_per_group(cfg, t_total)
    pad = (-t_total) % tpg
    x2d, idx = x.reshape(t_total, d), idx.long()
    if pad:
        # pad rows route to expert 0 with gate 0 for all k choices: they
        # take slots in expert 0's buffer ahead of the real tokens' later
        # choices, as in the JAX package
        x2d = F.pad(x2d, (0, 0, 0, pad))
        gates = F.pad(gates, (0, 0, 0, pad))
        idx = F.pad(idx, (0, 0, 0, pad))
    g = x2d.shape[0] // tpg
    cap = capacity(cfg, tpg)
    # each (token, choice)'s position in its expert's buffer: an exclusive
    # count over the choice-major flattening [g, k·t]
    flat = idx.reshape(g, tpg, k).transpose(1, 2).reshape(g, k * tpg)
    oh = F.one_hot(flat, e)
    pos = (oh.cumsum(1) - oh).gather(2, flat[..., None])
    pos = pos.reshape(g, k, tpg).transpose(1, 2).reshape(g * tpg, k)
    keep = pos < cap
    # the buffer is [E, g, C] slots of d, one more row for every drop;
    # kept slots are distinct, so the scatter writes each once
    group = torch.arange(g, device=x.device).repeat_interleave(tpg)[:, None]
    slot = torch.where(keep, (idx * g + group) * cap + pos, e * g * cap)
    xe = x2d.new_zeros((e * g * cap + 1, d))
    xe[slot.reshape(-1)] = x2d.repeat_interleave(k, 0)
    ye = _expert_ffn(moe, xe[:-1].view(e, g * cap, d)).reshape(-1, d)
    ye_sel = ye[torch.where(keep, slot, 0).reshape(-1)].view(-1, k, d)
    out = _combine(ye_sel, gates.to(x.dtype) * keep, x.dtype)
    return out[:t_total].reshape(b, s, d), keep[:t_total]


def dense_from_routing(moe: MoE, x, gates, idx, cfg: ModelConfig):
    """The dense path after the router: every expert on every token, the
    top-k outputs combined with their gates. x [B, S, d]; gates, idx
    [T, k]. Returns [B, S, d]."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    ye = _expert_ffn(moe, x2d)  # [E, T, d]
    tok = torch.arange(b * s, device=x.device)[:, None]
    return _combine(ye[idx.long(), tok], gates, x.dtype).reshape(b, s, d)


def moe_apply_capacity(moe: MoE, x, cfg: ModelConfig):
    gates, idx = _router(moe, x.reshape(-1, x.shape[-1]), cfg)
    return capacity_from_routing(moe, x, gates, idx, cfg)[0]


def moe_apply_dense(moe: MoE, x, cfg: ModelConfig):
    gates, idx = _router(moe, x.reshape(-1, x.shape[-1]), cfg)
    return dense_from_routing(moe, x, gates, idx, cfg)


def moe_apply(moe: MoE, x, cfg: ModelConfig, impl: str = "capacity"):
    """x [B, S, d] -> [B, S, d]. One token a sequence always takes the
    exact dense path: every expert's weights stream from memory at decode
    anyway, and drops there would make decode differ from prefill."""
    if impl not in IMPLS:
        raise ValueError(f"moe_apply: impl {impl!r} is not one of {IMPLS}")
    if impl == "dense" or x.shape[1] == 1:
        return moe_apply_dense(moe, x, cfg)
    return moe_apply_capacity(moe, x, cfg)
