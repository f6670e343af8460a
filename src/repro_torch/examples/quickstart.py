"""Quickstart: the paper's model and Wolf in a minute (the counterpart of
``examples/quickstart.py``, plus ``--device`` and ``--writes``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (
    allocate_closed_form,
    delta_from_op_ratio,
    optimal_allocation,
    total_wa,
    wa_from_op_ratio,
)
from repro_torch.core import managers as M
from repro_torch.core import workloads as W
from repro_torch.core.ssd import Geometry


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--writes", type=int, default=40_000,
                    help="writes a phase of the swap in part 3")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    print("=== 1. The closed-form WA model (paper §4) ===")
    for r in (0.6, 0.7, 0.8, 0.9):
        print(f"  LBA/PBA={r:.2f}  δ={float(delta_from_op_ratio(t(r))):.3f}"
              f"  WA={float(wa_from_op_ratio(t(r))):.2f}")

    print("\n=== 2. Near-optimal OP allocation (paper §5.5, eq. 8) ===")
    s = t([50_000.0, 30_000.0, 20_000.0])  # group sizes (pages)
    p = t([0.1, 0.3, 0.6])                  # update frequencies
    op = t(40_000.0)                        # spare pages
    cf = allocate_closed_form(s, p, op)
    opt = optimal_allocation(s, p, op)
    print(f"  closed form: {cf.cpu().numpy().round(0)}  "
          f"WA={float(total_wa(s, p, cf)):.4f}")
    print(f"  optimum:     {opt.cpu().numpy().round(0)}  "
          f"WA={float(total_wa(s, p, opt)):.4f}")

    print("\n=== 3. Wolf vs FDP across a workload swap (paper §6.1) ===")
    geom = Geometry(n_luns=4, blocks_per_lun=48, pages_per_block=16)
    ph1, ph2 = W.swap_phases(geom.lba_pages, args.writes, p=(0.1, 0.9))
    for name, mcfg in (("wolf", M.wolf()), ("fdp", M.fdp())):
        swap = M.simulate(geom, mcfg, [ph1, ph2], seed=0, device=dev)
        noswap = M.simulate(geom, mcfg, [ph1, ph1], seed=0, device=dev)
        extra = float(np.int64(swap.mig[-1]) - np.int64(noswap.mig[-1])) \
            / geom.pba_pages
        print(f"  {name:5s}: WA={swap.wa_total:.3f}  "
              f"extra migrations/PBA={extra:+.3f}")

    print("\nSee repro_torch.examples.ssd_experiment, train_lm and "
          "serve_wolf_kv for more.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
