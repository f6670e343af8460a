"""Closed-form analytics of the paper's model, in PyTorch: the counterpart
of the part of ``repro.core.analytics`` that the fleet's results read.

  * eq. 3's LBA/PBA as a function of δ, its inversion by bisection, and
    WA = 1/(1-δ) (§4.2);
  * wear: the erase-count variance from the carried aggregates, the
    max/mean P-E imbalance, and the host writes and drive-writes-per-day a
    P-E budget allows at a measured WA and imbalance;
  * survival: the retired fraction of the block array, the utilization
    and equilibrium WA of a drive that retired it, and a fleet's survival
    curve from its drives' degradation times;
  * the windowed WA over a drive's lifetime from its cumulative trace.

Values are float32, as the JAX package computes them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "op_ratio_from_delta",
    "delta_from_op_ratio",
    "wa_from_delta",
    "wa_from_op_ratio",
    "wear_variance",
    "wear_imbalance",
    "lifetime_host_writes",
    "dwpd_from_lifetime",
    "retired_fraction",
    "degraded_op_ratio",
    "wa_with_retirement",
    "survival_fraction",
    "wa_vs_lifetime",
]


def op_ratio_from_delta(delta: torch.Tensor) -> torch.Tensor:
    """Eq. (3): LBA/PBA as a function of δ, (δ-1)/ln(δ), with δ kept in
    [1e-12, 1 − 1e-7] (the removable singularity at δ = 1)."""
    d = torch.clamp(torch.as_tensor(delta), 1e-12, 1.0 - 1e-7)
    return (d - 1.0) / torch.log(d)


def wa_from_delta(delta: torch.Tensor) -> torch.Tensor:
    """WA = 1/(1-δ) (paper §4.2)."""
    return 1.0 / (1.0 - torch.as_tensor(delta))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def delta_from_op_ratio(r, *, iters: int = 80) -> torch.Tensor:
    """Eq. (3) inverted: the δ in (0, 1) with (δ-1)/ln(δ) = r, by a
    fixed count of float32 bisection steps over [1e-9, 1 − 1e-9] (the
    function is strictly increasing there)."""
    r = _f32(r)
    lo = torch.full(r.shape, 1e-9, dtype=torch.float32)
    hi = torch.full(r.shape, 1.0 - 1e-9, dtype=torch.float32)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_low = op_ratio_from_delta(mid) < r  # δ must grow
        lo = torch.where(too_low, mid, lo)
        hi = torch.where(too_low, hi, mid)
    return 0.5 * (lo + hi)


def wa_from_op_ratio(r, *, iters: int = 80) -> torch.Tensor:
    """Equilibrium WA of a uniform workload at utilization ratio r."""
    return wa_from_delta(delta_from_op_ratio(r, iters=iters))


def wear_variance(erase_total, erase_sq_total, n_blocks: int) -> torch.Tensor:
    """Population variance of per-block erase counts from the carried
    aggregates: Var[e] = Σe²/K − (Σe/K)²."""
    n = _f32(n_blocks)
    mean = _f32(erase_total) / n
    return _f32(erase_sq_total) / n - mean * mean


def wear_imbalance(erase_count) -> torch.Tensor:
    """Max/mean P-E ratio over a drive's block array (1.0 = perfectly
    level; also at the start of life, with no erase yet)."""
    e = _f32(erase_count)
    mean = e.mean()
    return torch.where(mean > 0.0, e.max() / torch.clamp(mean, min=1e-12),
                       1.0)


def lifetime_host_writes(*, n_blocks: int, pages_per_block: int,
                         pe_cycles: float, wa, imbalance) -> torch.Tensor:
    """Host writes (pages) until the worst block exhausts its P-E budget:
    K · B · PE / (WA · max(imbalance, 1))."""
    phys_budget = _f32(n_blocks * pages_per_block * pe_cycles)
    return phys_budget / (_f32(wa) * torch.clamp(_f32(imbalance), min=1.0))


def dwpd_from_lifetime(host_pages, *, lba_pages: int,
                       years: float = 5.0) -> torch.Tensor:
    """Drive-writes-per-day sustainable over a ``years`` warranty window:
    host_pages / (lba_pages · days)."""
    days = _f32(years * 365.0)
    return _f32(host_pages) / (_f32(lba_pages) * days)


def retired_fraction(retired_blocks, n_blocks: int) -> torch.Tensor:
    """Fraction of the block array RETIRED: the carried
    ``retired_blocks`` over K."""
    return _f32(retired_blocks) / _f32(n_blocks)


def degraded_op_ratio(r, retired_frac) -> torch.Tensor:
    """Utilization ratio of a drive that retired a fraction f of its
    blocks: LBA / (PBA·(1 − f)) = r / (1 − f), kept below 1 so eq. 3
    stays defined once retirement has eaten the whole OP."""
    r, f = _f32(r), _f32(retired_frac)
    return torch.clamp(r / torch.clamp(1.0 - f, min=1e-9), max=1.0 - 1e-7)


def wa_with_retirement(r, retired_frac, *, iters: int = 80) -> torch.Tensor:
    """Equilibrium WA of a uniform workload on a drive that retired a
    fraction ``retired_frac`` of its blocks: eq. 3 at the shrunken OP."""
    return wa_from_op_ratio(degraded_op_ratio(r, retired_frac), iters=iters)


def survival_fraction(degraded_at, t) -> torch.Tensor:
    """Fraction of a fleet's drives in service at write index ``t`` (any
    shape): a drive survives t iff it never degraded (``degraded_at`` -1,
    as ``FleetResult.time_to_degraded`` gives it) or degraded after t."""
    d = torch.as_tensor(np.asarray(degraded_at))[:, None]
    t = torch.as_tensor(np.asarray(t))
    alive = (d < 0) | (d > t.reshape(-1))
    # the mean as the JAX package rounds it: the sum times float32(1 / B)
    inv = torch.tensor(1.0 / d.shape[0], dtype=torch.float32)
    return (alive.to(torch.float32).sum(0) * inv).reshape(t.shape)


def wa_vs_lifetime(app, mig, *, window: int = 2000,
                   stride: int = 1) -> np.ndarray:
    """[K] windowed WA over one drive's lifetime from its cumulative
    (app, mig) trace, NaN for a window that completes no application write.
    ``window`` counts events and must be a multiple of the trace stride,
    with ``RunResult.wa_curve``'s window boundaries."""
    if window % stride:
        raise ValueError(f"window {window} is no multiple of {stride}")
    w = window // stride
    app, mig = np.asarray(app), np.asarray(mig)
    idx = np.arange(w, len(app) + 1, w) - 1
    prev = np.maximum(idx - w, -1)
    d_app = app[idx] - np.where(prev >= 0, app[prev], 0)
    d_mig = mig[idx] - np.where(prev >= 0, mig[prev], 0)
    return np.where(
        d_app > 0, (d_app + d_mig) / np.maximum(d_app, 1), np.nan
    )
