"""A configurable SSD simulation campaign, the paper's own kind of
experiment (the counterpart of ``examples/ssd_experiment.py``, plus
``--device``).

    PYTHONPATH=src python -m repro_torch.examples.ssd_experiment \
        --workload swap --managers wolf,fdp,single --writes 100000
"""

from __future__ import annotations

import argparse

from repro_torch.core import managers as M
from repro_torch.core import workloads as W
from repro_torch.core.ssd import Geometry

PRESETS = {
    "wolf": M.wolf, "fdp": M.fdp, "single": M.single_group,
    "wolf_lru": M.wolf_lru, "wolf_dynamic": M.wolf_dynamic,
    "wolf_endurance": M.wolf_endurance,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("uniform", "swap", "tpcc", "exp5"),
                    default="swap")
    ap.add_argument("--managers", default="wolf,fdp")
    ap.add_argument("--writes", type=int, default=100_000)
    ap.add_argument("--lba-pba", type=float, default=0.7)
    ap.add_argument("--blocks-per-lun", type=int, default=64)
    ap.add_argument("--pages-per-block", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    geom = Geometry(blocks_per_lun=args.blocks_per_lun,
                    pages_per_block=args.pages_per_block,
                    lba_pba=args.lba_pba)
    lba = geom.lba_pages
    if args.workload == "uniform":
        phases = [W.uniform(lba, args.writes)]
    elif args.workload == "swap":
        phases = list(W.swap_phases(lba, args.writes))
    elif args.workload == "exp5":
        base = W.exponential_groups(lba, args.writes)
        phases = [base, W.pairwise_swap(base, 0, 4, args.writes)]
    else:
        phases = [W.tpcc_like(lba, args.writes)]

    print(f"SSD: {geom.n_blocks} blocks × {geom.pages_per_block} pages, "
          f"LBA/PBA={geom.lba_pba}  workload={args.workload}")
    for name in args.managers.split(","):
        res = M.simulate(geom, PRESETS[name](), phases, seed=args.seed,
                         device=args.device)
        curve = res.wa_curve(max(2000, args.writes // 20))
        spark = " ".join(f"{x:.2f}"
                         for x in curve[::max(1, len(curve) // 12)])
        print(f"  {name:12s} WA={res.wa_total:.3f}   over time: {spark}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
