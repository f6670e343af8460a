"""Over-provisioning allocation across temperature groups (paper §5.5).

The counterpart of the part of ``repro.core.allocation`` that the simulator's
§5.1 interval update and the fleet's analytics call: the three closed-form
policies over float32 tensors of group sizes ``s`` and update frequencies
``p``, and the eq. 5 model WA.

  * ``allocate_by_size``       eq. (6):  OP_x = s_x · V,  V = OP/LBA
  * ``allocate_by_frequency``  eq. (7):  OP_x = p_x · OP
  * ``allocate_closed_form``   eq. (8):  the average of the two, plus the
                               §5.5.3 cold-group escape hatch.
  * ``total_wa``               eq. (5):  Σ_x p_x · WA(s_x, OP_x), each group
                               a uniform sub-SSD whose δ_x solves eq. 4.

The group axis is the last one: ``s`` and ``p`` may carry leading axes
(``[D, G]``, one row a drive), and each row's result is bit for bit the
result for that row alone.
"""

from __future__ import annotations

import torch

from repro_torch.core.analytics import op_ratio_from_delta, wa_from_delta

__all__ = [
    "fsum",
    "group_delta",
    "group_wa",
    "total_wa",
    "allocate_by_size",
    "allocate_by_frequency",
    "allocate_closed_form",
]


def fsum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum over the last axis of a short float tensor (a
    group axis); a ``[D, G]`` tensor gives ``[D]``.

    XLA:CPU reduces a vector this short in order, and the allocations are
    held to the JAX package's values bit for bit where they turn into block
    counts (``ceil`` in the simulator's §5.5 step). ``torch.sum`` uses
    another association on each device; this order is the same on all.
    """
    first, *rest = x.unbind(-1)
    for v in rest:
        first = first + v
    return first


# ---------------------------------------------------------------------------
# Eq. 5: the model WA of a group split (what FleetResult.predicted_wa reads)
# ---------------------------------------------------------------------------

def _delta_from_ratio(r: torch.Tensor) -> torch.Tensor:
    """δ with op_ratio_from_delta(δ) = r, by 80 float32 bisection steps on
    (1e-9, 1 − 1e-9), as the JAX package's. Its custom JVP (the implicit
    derivative) comes with ``optimal_allocation``, which is not ported
    yet: this version is not differentiated."""
    r = torch.as_tensor(r)
    lo = torch.full_like(r, 1e-9)
    hi = torch.full_like(r, 1.0 - 1e-9)
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        too_low = op_ratio_from_delta(mid) < r
        lo, hi = torch.where(too_low, mid, lo), torch.where(too_low, hi, mid)
    return 0.5 * (lo + hi)


def group_delta(s, op) -> torch.Tensor:
    """δ_x for a group of logical size ``s`` with over-provisioning ``op``."""
    s = torch.as_tensor(s, dtype=torch.float32)
    op = torch.as_tensor(op, dtype=torch.float32)
    r = s / torch.clamp(s + op, min=1e-30)
    return _delta_from_ratio(torch.clamp(r, 1e-6, 1.0 - 1e-7))


def group_wa(s, op) -> torch.Tensor:
    """WA(s_x, OP_x) = 1/(1-δ_x)."""
    return wa_from_delta(group_delta(s, op))


def total_wa(s, p, op) -> torch.Tensor:
    """Eq. (5): frequency-weighted overall write-amplification, over the
    last axis."""
    p = torch.as_tensor(p, dtype=torch.float32)
    return fsum(p * group_wa(s, op))


# ---------------------------------------------------------------------------
# The three closed-form policies (paper §5.5.1–5.5.3)
# ---------------------------------------------------------------------------

def _per_row(op_total, like: torch.Tensor) -> torch.Tensor:
    """``op_total`` (a number, or one value per row) as a float32 tensor
    that broadcasts against ``like``'s group axis."""
    op = torch.as_tensor(op_total, dtype=torch.float32, device=like.device)
    return op.unsqueeze(-1)


def allocate_by_size(s: torch.Tensor, op_total) -> torch.Tensor:
    """Eq. (6): OP_x = s_x · V with V = OP/LBA. Equalizes δ across groups."""
    s = torch.as_tensor(s, dtype=torch.float32)
    return s * (_per_row(op_total, s) / fsum(s).unsqueeze(-1))


def allocate_by_frequency(p: torch.Tensor, op_total) -> torch.Tensor:
    """Eq. (7): OP_x = p_x · OP."""
    p = torch.as_tensor(p, dtype=torch.float32)
    return p / fsum(p).unsqueeze(-1) * _per_row(op_total, p)


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
    no host read; the coldest group of each row is found by a stable sort,
    as in the JAX package, so ties resolve to the lowest index.
    """
    s = torch.as_tensor(s, dtype=torch.float32)
    p = torch.as_tensor(p, dtype=torch.float32, device=s.device)
    op_total = torch.as_tensor(op_total, dtype=torch.float32, device=s.device)
    n = s.shape[-1]

    def closed_form(s, p, op):
        v = op.unsqueeze(-1) / fsum(s).unsqueeze(-1)
        pn = p / torch.clamp(fsum(p), min=1e-30).unsqueeze(-1)
        return 0.5 * (s * v + pn * op.unsqueeze(-1))

    base = closed_form(s, p, op_total)
    if not cold_rule or n < 2:
        return base

    hit = p / torch.clamp(s, min=1e-30)
    order = torch.argsort(hit, dim=-1, stable=True)
    coldest = order[..., :1]
    hit_o, p_o = hit.gather(-1, order), p.gather(-1, order)
    is_skewed = (hit_o[..., 0] < cold_hit_rate_frac * hit_o[..., 1]) & (
        p_o[..., 0] / torch.clamp(fsum(p), min=1e-30) < 0.02
    )
    cold_op = torch.minimum(cold_op_frac * s.amin(-1), op_total)
    mask = torch.arange(n, device=s.device) != coldest
    rest = closed_form(
        torch.where(mask, s, 0.0), torch.where(mask, p, 0.0),
        op_total - cold_op,
    )
    with_cold = torch.where(mask, rest, cold_op.unsqueeze(-1))
    return torch.where(is_skewed.unsqueeze(-1), with_cold, base)
