"""Sweep a policy × workload grid as one batched fleet simulation (the
counterpart of ``examples/fleet_sweep.py``, plus ``--device``;
``--devices`` splits the drives over that many cards, "auto" every one,
as ``simulate_fleet(devices=)`` does).

Every (manager, workload, seed) combination is a drive of one lock-step
fleet (``core/fleet.simulate_fleet``, streams drawn on the device), and
the grid's WA landscape comes back from one call. Beside each simulated WA
stands the closed-form prediction (paper eq. 3/5 at the drive's final
operating point) and its relative error.

A TRIM axis: drives with a fraction t of the logical span trimmed at
steady state (the op-stream engine) against the Frankie effective-OP
prediction ``wa_from_op_ratio(effective_op_ratio(r, t))``: trimmed space
is dynamic over-provisioning, so WA falls with t along the model curve.

A wear sweep: (α, β, γ, τ) victim-score weight points (greedy, two
wear-leveling strengths, LRU) as one more fleet, each point's erase-count
variance, max/mean P-E imbalance and DWPD projection beside its WA.

    PYTHONPATH=src python -m repro_torch.examples.fleet_sweep --writes 20000 --seeds 2
"""

from __future__ import annotations


import argparse
import dataclasses

import numpy as np

from repro_torch.core import analytics as A
from repro_torch.core import managers as M
from repro_torch.core import workloads as W
from repro_torch.core.fleet import DriveSpec, simulate_fleet
from repro_torch.core.ssd import Geometry


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--writes", type=int, default=20_000)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--lba-pba", type=float, default=0.7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", default=None,
                    help='cards to split the drives over: an int or "auto"')
    args = ap.parse_args(argv)

    geom = Geometry(n_luns=4, blocks_per_lun=32, pages_per_block=8,
                    lba_pba=args.lba_pba)
    lba = geom.lba_pages
    managers = (("wolf", M.wolf), ("fdp", M.fdp), ("single", M.single_group))
    workloads = (
        ("two_modal", lambda: (W.two_modal(lba, args.writes),)),
        ("swap", lambda: tuple(W.swap_phases(lba, args.writes // 2))),
        ("tpcc", lambda: (W.tpcc_like(lba, args.writes),)),
    )
    specs = [
        DriveSpec(mk(), wl(), seed=seed, name=f"{mn}/{wn}#{seed}")
        for seed in range(args.seeds)
        for mn, mk in managers
        for wn, wl in workloads
    ]
    fleet = simulate_fleet(geom, specs, device=args.device,
                           devices=args.devices)

    print(f"{len(specs)} drives × {args.writes} writes "
          f"(geometry: {geom.n_blocks} blocks, LBA/PBA {geom.lba_pba})\n")
    window = max(args.writes // 10, 1000)
    predicted = fleet.predicted_wa()
    rel_err = fleet.model_error(window=window, pred=predicted)
    width = max(len(s.name) for s in specs)
    for i, s in enumerate(specs):
        curve = fleet.result(i).wa_curve(window)
        print(f"{s.name.ljust(width)}  WA_total={fleet.wa_total[i]:6.3f}  "
              f"WA_eq={np.mean(curve[-3:]):6.3f}  "
              f"WA_model={predicted[i]:6.3f}  err={rel_err[i]:+7.1%}")
    print(f"\nmodel vs simulation (eq. 3/5) across the grid: "
          f"mean |rel err| = {np.mean(np.abs(rel_err)):.1%}, "
          f"worst = {np.max(np.abs(rel_err)):.1%}")
    # the paper's bottom line, read off the grid: wolf ≤ fdp per workload
    for wn, _ in workloads:
        wa = {
            mn: np.mean([fleet.wa_total[i] for i, s in enumerate(specs)
                         if s.name.startswith(f"{mn}/{wn}")])
            for mn, _ in managers
        }
        print(f"\n{wn}: " + "  ".join(f"{k}={v:.3f}" for k, v in wa.items()))

    # -- TRIM sweep: utilization × trim-rate in one op-stream fleet ---------
    # Frankie et al.: trimmed space is dynamic OP, so the LRU single-group
    # drive should track wa_from_op_ratio(effective_op_ratio(r, t)).
    trim_fracs = (0.0, 0.1, 0.25, 0.5)
    mcfg = dataclasses.replace(M.single_group(), gc_policy="lru")
    trim_specs = [
        DriveSpec(mcfg, (W.trimmed(W.uniform(lba, args.writes), t),),
                  seed=11, name=f"single-lru/trim={t}")
        for t in trim_fracs
    ]
    trim_fleet = simulate_fleet(geom, trim_specs, device=args.device,
                                devices=args.devices)
    # reserve-adjusted base utilization, as in the Fig.-1 equilibrium test
    ppb = geom.pages_per_block
    usable = geom.pba_pages - 3 * ppb
    print("\nTRIM sweep (single-group LRU, Frankie effective-OP model):")
    errs = []
    for i, t in enumerate(trim_fracs):
        t_meas = trim_fleet.trim_fraction()[i]
        wa_sim = float(np.mean(trim_fleet.result(i).wa_curve(window)[-3:]))
        wa_model = float(A.wa_from_op_ratio(
            A.effective_op_ratio(geom.lba_pages / usable, t_meas)
        ))
        errs.append((wa_sim - wa_model) / wa_model)
        print(f"  t={t:4.2f} (measured {t_meas:5.3f})  WA_sim={wa_sim:6.3f}  "
              f"WA_model={wa_model:6.3f}  err={errs[-1]:+7.1%}")
    print(f"trim-sweep model vs simulation: mean |rel err| = "
          f"{np.mean(np.abs(errs)):.1%}, worst = {np.max(np.abs(errs)):.1%}")

    # -- wear weight sweep: (α, β, γ, τ) victim-score points in ONE grid ----
    # GC policy is a traced weight vector, so the endurance/WA trade-off is
    # a single fleet call: greedy is (1,0,0,0) and the wear points add
    # β·erase_count pressure to the same score. Endurance read-outs come
    # straight off the carried erase aggregates — no extra reduction.
    skew = (W.two_modal(lba, args.writes, p_hot=0.9, frac_hot=0.2),)
    points = [
        ("greedy     (β=0)   ", M.wolf()),
        ("wear       (β=0.25)", M.wolf_wear()),
        ("wear-heavy (β=1.0) ", dataclasses.replace(
            M.wolf_wear(), gc_beta=1.0)),
        ("lru        (γ=1)   ", M.wolf_lru()),
    ]
    wear_specs = [
        DriveSpec(mcfg, skew, seed=7, name=nm.split()[0])
        for nm, mcfg in points
    ]
    wear_fleet = simulate_fleet(geom, wear_specs, device=args.device,
                                devices=args.devices)
    wvar = wear_fleet.wear_variance()
    wimb = wear_fleet.wear_imbalance()
    dwpd = wear_fleet.lifetime_dwpd()
    print("\nwear weight sweep (skewed two_modal, p_hot=0.9/frac_hot=0.2):")
    for i, (nm, _) in enumerate(points):
        print(f"  {nm}  WA={wear_fleet.wa_total[i]:6.3f}  "
              f"Var[P-E]={wvar[i]:8.2f}  max/mean={wimb[i]:5.2f}  "
              f"DWPD@3k={dwpd[i]:6.2f}")
    var_ratio = wvar[0] / max(wvar[1], 1e-9)
    wa_delta = wear_fleet.wa_total[1] / wear_fleet.wa_total[0] - 1.0
    print(f"wear (β=0.25) vs greedy: erase-variance ÷{var_ratio:.1f} "
          f"for WA {wa_delta:+.1%} — leveling is not free, but cheap")
    # larger β overshoots: GC starts cleaning full cold blocks, churning
    # erases, so the variance win SHRINKS while the WA tax grows
    if var_ratio < 2.0:
        raise SystemExit(
            f"wear point should level >=2x vs greedy, got {var_ratio:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
