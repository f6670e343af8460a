"""AdamW with a mixed-precision master copy (the counterpart of
``repro.train.optimizer``).

Layout, as in the JAX package:
  * model params: ``cfg.dtype`` (bf16 at full width), what forward and
    backward see;
  * optimizer state: fp32 m, v and master params, and an int32 step count;
  * the update in fp32; params re-cast from the master every step.

Parameters, gradients and the state's m / v / master are dicts keyed by
parameter name (``nn.Module.named_parameters()``'s names and order). The
update runs leaf by leaf in place, so it needs one leaf's temporaries on
top of the state, never a second copy of it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio · lr``; fp32
    arithmetic on the step's device, as the JAX package's."""
    step = torch.as_tensor(step).to(F32)
    warm = step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    decayed = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decayed)


def adamw_init(params: dict) -> dict:
    """{"m", "v": fp32 zeros, "master": fp32 copies, keyed like
    ``params``; "count": int32 0} on the params' device."""
    p0 = next(iter(params.values()))
    return {
        "m": {k: torch.zeros_like(p, dtype=F32) for k, p in params.items()},
        "v": {k: torch.zeros_like(p, dtype=F32) for k, p in params.items()},
        "master": {k: p.detach().to(F32, copy=True)
                   for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=p0.device),
    }


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares, the leaves
    added one after another in the dict's order (the JAX package adds
    its leaves in sorted-key order, over layer-stacked leaves, so the
    two differ in the last bits)."""
    return torch.sqrt(sum(l.to(F32).square().sum() for l in tree.values()))


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params: dict,
                 cfg: OptimizerConfig) -> dict:
    """One AdamW step: updates ``opt_state`` and ``params`` in place and
    returns the metrics {"grad_norm" (before clipping), "lr"}."""
    count = opt_state["count"] + 1
    lr = lr_schedule(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    bc1 = 1 - cfg.b1 ** count.to(F32)
    bc2 = 1 - cfg.b2 ** count.to(F32)
    for k, p in params.items():
        m, v, w = opt_state["m"][k], opt_state["v"][k], opt_state["master"][k]
        g = grads[k].to(F32) * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g.square())
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * w
        w.copy_(w - lr * step)
        p.copy_(w)  # re-cast to the model's dtype
    opt_state["count"] = count
    return {"grad_norm": gnorm, "lr": lr}
