"""Over-provisioning allocation across temperature groups (paper §5.5).

The counterpart of the part of ``repro.core.allocation`` that the simulator's
§5.1 interval update calls: the three closed-form policies over float32
tensors of group sizes ``s`` and update frequencies ``p``.

  * ``allocate_by_size``       eq. (6):  OP_x = s_x · V,  V = OP/LBA
  * ``allocate_by_frequency``  eq. (7):  OP_x = p_x · OP
  * ``allocate_closed_form``   eq. (8):  the average of the two, plus the
                               §5.5.3 cold-group escape hatch.
"""

from __future__ import annotations

import torch

__all__ = [
    "fsum",
    "allocate_by_size",
    "allocate_by_frequency",
    "allocate_closed_form",
]


def fsum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum of a short float vector (a group axis).

    XLA:CPU reduces a vector this short in order, and the allocations are
    held to the JAX package's values bit for bit where they turn into block
    counts (``ceil`` in the simulator's §5.5 step). ``torch.sum`` uses
    another association on each device; this order is the same on all.
    """
    out = x[0]
    for v in x[1:]:
        out = out + v
    return out


def allocate_by_size(s: torch.Tensor, op_total) -> torch.Tensor:
    """Eq. (6): OP_x = s_x · V with V = OP/LBA. Equalizes δ across groups."""
    s = torch.as_tensor(s, dtype=torch.float32)
    return s * (op_total / fsum(s))


def allocate_by_frequency(p: torch.Tensor, op_total) -> torch.Tensor:
    """Eq. (7): OP_x = p_x · OP."""
    p = torch.as_tensor(p, dtype=torch.float32)
    return p / fsum(p) * op_total


def allocate_closed_form(
    s: torch.Tensor,
    p: torch.Tensor,
    op_total,
    *,
    cold_rule: bool = True,
    cold_hit_rate_frac: float = 0.05,
    cold_op_frac: float = 0.05,
) -> torch.Tensor:
    """Eq. (8): OP_x = (s_x·V + p_x·OP)/2, the paper's near-optimal form.

    §5.5.3 cold-group handling: when the coldest group's hit rate (p/s) is
    below ``cold_hit_rate_frac`` of the second-coldest group's (and its
    share of writes is under 2%), it receives ``cold_op_frac`` × (smallest
    group's logical size) and the closed form splits the rest. Masked, with
    no host read; the coldest group is found by a stable sort, as in the
    JAX package, so ties resolve to the lowest index.
    """
    s = torch.as_tensor(s, dtype=torch.float32)
    p = torch.as_tensor(p, dtype=torch.float32, device=s.device)
    op_total = torch.as_tensor(op_total, dtype=torch.float32, device=s.device)
    n = s.shape[0]

    def closed_form(s, p, op):
        v = op / fsum(s)
        pn = p / torch.clamp(fsum(p), min=1e-30)
        return 0.5 * (s * v + pn * op)

    base = closed_form(s, p, op_total)
    if not cold_rule or n < 2:
        return base

    hit = p / torch.clamp(s, min=1e-30)
    order = torch.argsort(hit, stable=True)
    coldest = order[0]
    hit_o, p_o = hit[order], p[order]  # gathers: no host read on the card
    is_skewed = (hit_o[0] < cold_hit_rate_frac * hit_o[1]) & (
        p_o[0] / torch.clamp(fsum(p), min=1e-30) < 0.02
    )
    cold_op = torch.minimum(cold_op_frac * s.min(), op_total)
    mask = torch.arange(n, device=s.device) != coldest
    rest = closed_form(
        torch.where(mask, s, 0.0), torch.where(mask, p, 0.0),
        op_total - cold_op,
    )
    with_cold = torch.where(mask, rest, cold_op)
    return torch.where(is_skewed, with_cold, base)
