"""The control of the check: the plain reference computed in bfloat16 (the
precision below the configuration's float32), put in the program's place,
on the drives a run of the cell checks, and held to the float32 reference
by the same three numbers. A check that the control passes could not tell
a lower-precision program from a sound one.

    python3 -m wabench.control --workload <name> --seeds 11,12,13 --experiments 7

The streams are drawn on the card when there is one (the cell's own
streams), else on the CPU; the reference runs on the host either way.
Prints one JSON line a seed, then one with the smallest reading of each
number over the seeds.
"""

from __future__ import annotations

import argparse
import json
import sys

from wabench import cell as cells
from wabench import check as checks
from wabench import harness, streams


def control(cell: dict, seed: int, experiments: int, device,
            workers: int = 4) -> dict:
    """The numbers compared for the bfloat16 control against the float32
    reference, over the drives that a run of ``experiments`` experiments
    checks."""
    config, traffic = cell["config"], cell["traffic"]
    params = streams.param_arrays(traffic["phases"],
                                  checks.lba_pages(config))
    n_total = int(params["counts"].sum())
    trim = checks.with_trim(traffic)
    jobs = []
    for e in range(experiments):
        for d in harness.strata(seed, e, int(traffic["drives"]),
                                int(traffic["check_drives"])):
            ops, lbas = streams.draw(streams.drive_seed(seed, e, d), params,
                                     n_total, trim, device)
            jobs.append({
                "config": config, "traffic": traffic,
                "precision": "float32", "lbas": lbas.cpu().numpy(),
                "ops": None if ops is None else ops.cpu().numpy(),
                "port": {"app": 0, "mig": 0, "state": {}}, "keep": True})
    refs = checks.run_jobs(jobs, workers)
    for job, ref in zip(jobs, refs):
        job.update(precision="bfloat16", keep=False,
                   port={"app": ref["app"], "mig": ref["mig"],
                         "state": ref["state"]})
    ctl = checks.run_jobs(jobs, workers)
    return {
        "seed": seed, "drives": len(jobs),
        "trace_mismatch": sum(r["trace_mismatch"] for r in ctl),
        "state_mismatch": sum(r["state_mismatch"] for r in ctl),
        "drives_caught": sum(1 for r in ctl
                             if r["trace_mismatch"] or r["state_mismatch"]),
        "wa_float32": [r["wa"] for r in refs],
        "wa_bfloat16": [r["wa"] for r in ctl],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--experiments", type=int, required=True)
    args = ap.parse_args(argv)
    import torch
    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = cells.load_cell(args.workload)
    rows = []
    for s in (int(x) for x in args.seeds.split(",")):
        rows.append(control(cell, s, args.experiments, device))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"workload": args.workload, "device": device,
                      "smallest": {k: min(r[k] for r in rows) for k in (
                          "trace_mismatch", "state_mismatch",
                          "drives_caught")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
