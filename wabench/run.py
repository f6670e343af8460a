"""Run one cell of the benchmark once, on the card of the machine it is
started on, and print its result as the last line of standard output:

    python3 -m wabench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Every figure besides the result (experiments, rounds, WA, the card and its
power limit, the check's details) is on the line before it; the numbers
the check compared, each with its limit, are the last lines of standard
error and the result's last key. Without a card, or with fewer cards than
the cell asks for, it exits with 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from wabench import cell as cells
    cell = cells.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} cards, the machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from wabench import harness
    line, info = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda", T_START)
    print(json.dumps({"info": info}), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
