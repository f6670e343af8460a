"""Over-provisioning allocation across temperature groups (paper §5.5).

The counterpart of ``repro.core.allocation``, over float32 tensors of group
sizes ``s`` and update frequencies ``p``:

  * ``allocate_by_size``       eq. (6):  OP_x = s_x · V,  V = OP/LBA
  * ``allocate_by_frequency``  eq. (7):  OP_x = p_x · OP
  * ``allocate_closed_form``   eq. (8):  the average of the two, plus the
                               §5.5.3 cold-group escape hatch.
  * ``total_wa``               eq. (5):  Σ_x p_x · WA(s_x, OP_x), each group
                               a uniform sub-SSD whose δ_x solves eq. 4;
                               differentiable through the implicit
                               derivative of δ.
  * ``optimal_allocation``     eq. (5) minimized on the simplex by
                               exponentiated gradient (the paper's oracle
                               baseline [20, 9]).
  * ``hillclimb_allocation``   the literal block-granularity hill climber.

The group axis is the last one: ``s`` and ``p`` may carry leading axes
(``[D, G]``, one row a drive), and each row's result is bit for bit the
result for that row alone. The two optima take one ``[G]`` split.
"""

from __future__ import annotations

import numpy as np
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
    "optimal_allocation",
    "hillclimb_allocation",
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
# Eq. 5: the model WA of a group split, differentiable in OP
# ---------------------------------------------------------------------------

def _bisect_delta(r: torch.Tensor) -> torch.Tensor:
    """δ with op_ratio_from_delta(δ) = r, by 80 float32 bisection steps on
    (1e-9, 1 − 1e-9), as the JAX package's."""
    lo = torch.full_like(r, 1e-9)
    hi = torch.full_like(r, 1.0 - 1e-9)
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        too_low = op_ratio_from_delta(mid) < r
        lo, hi = torch.where(too_low, mid, lo), torch.where(too_low, hi, mid)
    return 0.5 * (lo + hi)


class _DeltaFromRatio(torch.autograd.Function):
    """δ(r) by bisection, differentiated implicitly: with f(δ) =
    (δ−1)/ln δ, f'(δ) = (ln δ − (δ−1)/δ) / ln² δ and dδ/dr = 1 / f'(δ)
    (the JAX package's custom JVP, transposed)."""

    @staticmethod
    def forward(ctx, r):
        delta = _bisect_delta(r)
        ctx.save_for_backward(delta)
        return delta

    @staticmethod
    def backward(ctx, grad):
        (delta,) = ctx.saved_tensors
        ln = torch.log(delta)
        fprime = (ln - (delta - 1.0) / delta) / (ln * ln)
        return grad / fprime


# δ with op_ratio_from_delta(δ) = r, for a float32 tensor r
_delta_from_ratio = _DeltaFromRatio.apply


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


# ---------------------------------------------------------------------------
# Oracle optima (the paper's comparison baselines)
# ---------------------------------------------------------------------------

def optimal_allocation(s, p, op_total, *, steps: int = 600,
                       lr: float = 0.25) -> torch.Tensor:
    """Minimize eq. (5) over the simplex {OP_x ≥ 0, Σ OP_x = OP}.

    The space is convex (§5.5.3), so exponentiated gradient on
    ``softmax(θ)`` converges to the optimum: from the closed form (without
    the cold rule), each step takes eq. 5's gradient by autograd (non-finite
    entries zeroed), normalizes it by its largest magnitude and moves θ by
    ``lr / (1 + 0.02 i)``, float32 as the JAX package rounds it; the best θ
    seen is kept. A plain loop on the inputs' device. Returns float32 [G].
    """
    s = torch.as_tensor(s, dtype=torch.float32)
    p = torch.as_tensor(p, dtype=torch.float32, device=s.device)
    op_total = torch.as_tensor(op_total, dtype=torch.float32, device=s.device)
    init = allocate_closed_form(s, p, op_total, cold_rule=False)
    theta = torch.log(torch.clamp(init / op_total, min=1e-6))

    def objective(theta):
        return total_wa(s, p, torch.softmax(theta, -1) * op_total)

    best_theta = theta
    with torch.no_grad():
        best_wa = objective(theta)
    for i in range(steps):
        th = theta.detach().requires_grad_(True)
        wa = objective(th)
        (g,) = torch.autograd.grad(wa, th)
        wa = wa.detach()
        better = wa < best_wa
        best_theta = torch.where(better, theta, best_theta)
        best_wa = torch.where(better, wa, best_wa)
        g = torch.where(torch.isfinite(g), g, 0.0)
        gnorm = torch.clamp(g.abs().amax(), min=1e-30)
        # float32, as the JAX package's step over its int32 counter
        step = np.float32(lr) / (np.float32(1.0) + np.float32(0.02) * i)
        theta = theta - float(step) * g / gnorm
    return torch.softmax(best_theta, -1) * op_total


def hillclimb_allocation(s, p, op_total, *, block_pages: int = 128,
                         max_moves: int = 10_000) -> torch.Tensor:
    """The literal hill climber of [20]: from the proportional split, move
    one block of OP from the group whose WA suffers least to the group
    whose WA gains most while that improves eq. 5 by more than 1e-9
    (globally optimal to block granularity, by convexity). A move
    evaluates the G givers as one ``total_wa`` call over a candidate axis,
    then the G takers as another, and reads one decision on the host.
    Returns float32 [G] on the inputs' device."""
    s = torch.as_tensor(s, dtype=torch.float32)
    p = torch.as_tensor(p, dtype=torch.float32, device=s.device)
    n = s.shape[-1]
    step = float(block_pages)
    op = allocate_by_size(s, op_total)
    eye = torch.eye(n, dtype=torch.float32, device=s.device) * step
    idx = torch.arange(n, device=s.device)
    for _ in range(max_moves):
        base = total_wa(s, p, op)
        # WA after donating one block FROM group i (if it holds one)
        wa_minus = torch.where(op >= step, total_wa(s, p, op - eye),
                               torch.inf)
        giver = torch.argmin(wa_minus).reshape(1)
        # WA after then granting that block TO group j
        op_after_take = op - eye.index_select(0, giver)[0]
        wa_plus = torch.where(idx == giver, torch.inf,
                              total_wa(s, p, op_after_take + eye))
        taker = torch.argmin(wa_plus).reshape(1)
        if not bool(wa_plus.index_select(0, taker)[0] < base - 1e-9):
            break
        op = op_after_take + eye.index_select(0, taker)[0]
    return op
