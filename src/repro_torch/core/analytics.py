"""Closed-form analytics of the paper's model, in PyTorch: the counterpart
of ``repro.core.analytics``.

  * eq. 1 and 2: a block's decay under a uniform workload (§4.1);
  * eq. 3's LBA/PBA as a function of δ, its inversion by bisection, and
    WA = 1/(1-δ) with its inverse (§4.2);
  * TRIM as dynamic over-provisioning: the effective utilization of a
    drive holding part of its logical span trimmed, and its equilibrium
    WA;
  * wear: the erase-count variance from the carried aggregates, the
    max/mean P-E imbalance, and the host writes and drive-writes-per-day a
    P-E budget allows at a measured WA and imbalance;
  * survival: the retired fraction of the block array, the utilization
    and equilibrium WA of a drive that retired it, and a fleet's survival
    curve from its drives' degradation times;
  * the windowed WA over a drive's lifetime from its cumulative trace;
  * Appendix A: eq. 9, δ through the principal branch of Lambert's W.

Values are float32, as the JAX package computes them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "block_decay_updates",
    "block_live_pages",
    "op_ratio_from_delta",
    "delta_from_op_ratio",
    "delta_from_op_ratio_lambertw",
    "wa_from_delta",
    "delta_from_wa",
    "wa_from_op_ratio",
    "op_ratio_from_wa",
    "effective_op_ratio",
    "wa_with_trim",
    "lambertw0",
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


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def block_decay_updates(g, *, b: float, lba: float) -> torch.Tensor:
    """Eq. (1): the application updates X until a freshly written block of
    ``b`` pages has decayed to ``g`` live pages, under a uniform workload
    over ``lba`` logical pages: X = LBA · ln(B / G)."""
    return lba * torch.log(b / _f32(g))


def block_live_pages(x, *, b: float, lba: float) -> torch.Tensor:
    """Eq. (2): the live pages G left after ``x`` application updates:
    G = B · exp(−X / LBA)."""
    return b * torch.exp(-_f32(x) / lba)


def op_ratio_from_delta(delta: torch.Tensor) -> torch.Tensor:
    """Eq. (3): LBA/PBA as a function of δ, (δ-1)/ln(δ), with δ kept in
    [1e-12, 1 − 1e-7] (the removable singularity at δ = 1)."""
    d = torch.clamp(torch.as_tensor(delta), 1e-12, 1.0 - 1e-7)
    return (d - 1.0) / torch.log(d)


def wa_from_delta(delta: torch.Tensor) -> torch.Tensor:
    """WA = 1/(1-δ) (paper §4.2)."""
    return 1.0 / (1.0 - torch.as_tensor(delta))


def delta_from_wa(wa) -> torch.Tensor:
    """Inverse of :func:`wa_from_delta`: δ = 1 − 1/WA."""
    return 1.0 - 1.0 / _f32(wa)


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


def op_ratio_from_wa(wa) -> torch.Tensor:
    """The utilization ratio r = LBA/PBA at which a uniform workload's
    equilibrium WA is ``wa`` (eq. 3 in closed form)."""
    return op_ratio_from_delta(delta_from_wa(wa))


def effective_op_ratio(r, trim_frac) -> torch.Tensor:
    """Utilization ratio of a drive holding a fraction ``trim_frac`` of its
    logical span TRIMMED (Frankie et al., arXiv:1208.1794): a trimmed page
    holds no physical slot, so r_eff = (1 − t)·LBA / PBA = r·(1 − t)."""
    return _f32(r) * (1.0 - _f32(trim_frac))


def wa_with_trim(r, trim_frac, *, iters: int = 80) -> torch.Tensor:
    """Equilibrium WA of a uniform workload at utilization ``r`` with a
    fraction ``trim_frac`` of the logical span trimmed: eq. 3 at the
    effective ratio."""
    return wa_from_op_ratio(effective_op_ratio(r, trim_frac), iters=iters)


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


def lambertw0(a, *, iters: int = 32) -> torch.Tensor:
    """The principal branch W0 of Lambert's W for a >= -1/e, by a fixed
    count of float32 Halley steps from the JAX package's first guess (the
    series about the branch point below -0.2, log1p above 0, ``a`` in
    between). A step whose residual is 0 or whose denominator vanishes
    (the branch point, w = -1) leaves w as it is."""
    a = _f32(a)
    e = torch.ones((), dtype=torch.float32, device=a.device).exp()
    p = torch.sqrt(torch.clamp(2.0 * (e * a + 1.0), min=0.0))
    w_branch = -1.0 + p - p * p / 3.0  # the series about a = -1/e
    w_log = torch.where(a > 0, torch.log1p(a), a)
    w = torch.where(a < -0.2, w_branch, w_log)
    for _ in range(iters):
        ew = torch.exp(w)
        f = w * ew - a
        denom = ew * (w + 1.0) - (w + 2.0) * f / (2.0 * w + 2.0)
        step = torch.where(denom.abs() > 1e-30, f / denom, 0.0)
        w = torch.where(f.abs() > 0.0, w - step, w)
    return w


def delta_from_op_ratio_lambertw(r) -> torch.Tensor:
    """Eq. (9): δ = −r · W0(−(1/r) · e^(−1/r)), the equilibrium root in
    (0, 1) (W−1 would give the trivial root δ = 1); the same δ as
    :func:`delta_from_op_ratio`."""
    r = _f32(r)
    z = 1.0 / r  # PBA/LBA > 1
    return -r * lambertw0(-z * torch.exp(-z))
