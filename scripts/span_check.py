"""Check the simulator's spans on the card, for one benchmark cell.

    python3 scripts/span_check.py --workload <cell> --seed <n>

Runs the cell's warm experiment, then its first experiment under
``torch.profiler`` (CPU and CUDA activity), as ``wabench.harness`` traces
it, and prints one JSON line: the card and its power limit; the traced
wall time; the span counts beside the program's counters over that
experiment (``sim.round`` = rounds, ``host.sync`` = host syncs, the three
``gc.<mode>`` spans = ``gc_one`` launches, ``gc.demote_drain`` =
``compact_slots`` launches); each layer's share of the ``fleet.simulate``
span; whether every ``write_run`` kernel's launch (its runtime API event,
joined to the kernel by correlation id) lies inside a ``sim.round`` span,
and by how much at worst; whether any device event carries a span's name
or is a user annotation; and the cost of one span with a profiler active
and with none, from a loop of empty spans.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from wabench import cell as cells  # noqa: E402
from wabench import harness  # noqa: E402

GC_MODES = ("gc.gc", "gc.valve", "gc.movement")


def span_cost(spans, n: int) -> float:
    """µs a span: n empty spans under whatever profiler state holds."""
    t = time.perf_counter()
    for _ in range(n):
        with spans.span("host.sync"):
            pass
    return (time.perf_counter() - t) / n * 1e6


def launches_inside(events, recorded, kernel: str, span_name: str) -> dict:
    """Each ``kernel`` launch's runtime event against the ``span_name``
    spans (which never nest): how many, how many inside, and the worst
    distance outside in ns."""
    runtime = {e.correlation_id(): e for e in events
               if str(e.device_type()).endswith("CPU")
               and e.name().startswith("cu") and e.correlation_id()}
    of = sorted((s.start_ns, s.end_ns) for s in recorded
                if s.name == span_name)
    starts = [a for a, _ in of]
    n = found = inside = 0
    worst = 0
    for e in events:
        if not (str(e.device_type()).endswith("CUDA") and kernel in e.name()):
            continue
        n += 1
        r = runtime.get(e.correlation_id())
        if r is None:
            continue
        found += 1
        i = bisect.bisect_right(starts, r.start_ns()) - 1
        out = max(0, r.end_ns() - of[i][1]) if i >= 0 else float("inf")
        inside += out == 0
        worst = max(worst, out)
    return {"kernels": n, "launch_events": found, "inside": inside,
            "worst_outside_ns": worst}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing measured", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from repro_torch.kernels import _build
    from repro_torch.utils import spans

    cell = cells.load_cell(args.workload)
    prog = harness.Program(cell["config"], cell["traffic"], "cuda")
    _build.build_all()
    prog.experiment(args.seed, harness.WARM, prog.warm_phases)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    c0 = prog.counters()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        res = prog.experiment(args.seed, 0)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    counts = {k: v - c0[k] for k, v in prog.counters().items()}
    del res
    with torch.profiler.profile(activities=acts):
        on_us = span_cost(spans, 200_000)
    off_us = span_cost(spans, 1_000_000)

    recorded = spans.RECORDER.spans
    root = next(s for s in reversed(recorded) if s.name == "fleet.simulate")
    mine = [s for s in recorded if s.start_ns >= root.start_ns
            and s.end_ns <= root.end_ns]
    names = collections.Counter(s.name for s in mine)
    b = spans.fleet_breakdown()
    events = list(prof.profiler.kineto_results.events())
    device = [e for e in events if str(e.device_type()).endswith("CUDA")]
    out = {
        "cell": args.workload, "seed": args.seed,
        "card": harness.power_limit(), "traced_wall_s": wall_s,
        "span_wall_s": b["wall_ns"] * 1e-9,
        "spans": dict(names), "dropped": spans.RECORDER.dropped,
        "counts": counts,
        "agree": {
            "rounds": names["sim.round"] == counts["rounds"],
            "host_syncs": names["host.sync"] == counts["host_syncs"],
            "gc_one": sum(names[m] for m in GC_MODES)
            == counts["gc_one_launches"],
            "compact_slots": names["gc.demote_drain"]
            == counts["compact_slots_launches"],
        },
        "shares_pct": {k: 100.0 * v["self_ns"] / b["wall_ns"]
                       for k, v in b["layers"].items()},
        "mean_ms": {k: v["total_ns"] / v["count"] * 1e-6
                    for k, v in b["names"].items()},
        "write_run_in_round": launches_inside(
            events, mine, "write_run_kernel", "sim.round"),
        "device_events": len(device),
        "device_span_names": sorted({e.name() for e in device}
                                    & set(spans.LAYERS)),
        "user_annotations_on_device": sum(e.is_user_annotation()
                                          for e in device),
        "span_us_profiler_on": on_us, "span_us_off": off_us,
    }
    out["shares_sum_pct"] = sum(out["shares_pct"].values())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
