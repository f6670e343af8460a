"""Assemble the dry-run's roofline tables from
reports/dryrun_torch/*.json (the counterpart of ``repro.utils.report``).

    PYTHONPATH=src python -m repro_torch.utils.report              # card
    PYTHONPATH=src python -m repro_torch.utils.report --mesh single
    PYTHONPATH=src python -m repro_torch.utils.report --csv

On the ``single`` and ``multi`` meshes the count's per-device terms are
null (``launch/dryrun.py``): their rows show "—" there and the
placement's bytes a device.
"""

from __future__ import annotations

import argparse
import json
import pathlib

CELL_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
REPORT_DIR = "reports/dryrun_torch"


def load_cells(directory=REPORT_DIR):
    cells = {}
    for f in pathlib.Path(directory).glob("*.json"):
        d = json.loads(f.read_text())
        cells[(d["arch"], d["shape"], d["mesh"])] = d
    return cells


def _fmt_s(x):
    if x is None:
        return "—"
    if x == 0:
        return "0"
    if x < 1e-4:
        return f"{x*1e6:.1f}µs"
    if x < 0.1:
        return f"{x*1e3:.2f}ms"
    return f"{x:.3f}s"


def _fmt(x, spec):
    return "—" if x is None else format(x, spec)


def roofline_rows(cells, mesh="card"):
    rows = []
    for (arch, shape, m), d in sorted(cells.items()):
        if m != mesh:
            continue
        if d.get("skipped"):
            rows.append({"arch": arch, "shape": shape, "skipped": True})
            continue
        if "error" in d:
            rows.append({"arch": arch, "shape": shape, "error": True})
            continue
        r = d["roofline"]
        mem = d.get("memory", {})
        rows.append({
            "arch": arch,
            "shape": shape,
            "compute_s": r["compute_s"],
            "memory_s": r["memory_s"],
            "floor_s": r.get("memory_floor_s", 0),
            "coll_s": r["collective_s"],
            "dominant": r["dominant"],
            "useful": r["useful_flops_ratio"],
            "roofline_frac": r["roofline_fraction"],
            "hbm_gb": mem.get("per_device_hbm_bytes", 0) / 2**30,
        })
    return rows


def markdown_table(rows) -> str:
    hdr = (
        "| arch | shape | compute | memory (floor) | collective | dominant "
        "| useful-FLOPs | roofline-frac | HBM GB/dev |"
    )
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        if r.get("skipped"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | skipped "
                f"(full attention @500k) | — | — | — |"
            )
            continue
        if r.get("error"):
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(r['compute_s'])} "
            f"| {_fmt_s(r['memory_s'])} ({_fmt_s(r['floor_s'])}) "
            f"| {_fmt_s(r['coll_s'])} | {r['dominant'] or '—'} "
            f"| {_fmt(r['useful'], '.3f')} | {_fmt(r['roofline_frac'], '.3f')} "
            f"| {r['hbm_gb']:.2f} |"
        )
    return "\n".join(lines)


def dryrun_summary(cells) -> str:
    ok = sum(
        1 for d in cells.values() if not d.get("skipped") and "error" not in d
    )
    skipped = sum(1 for d in cells.values() if d.get("skipped"))
    failed = sum(1 for d in cells.values() if "error" in d)
    lines = [
        f"cells: {len(cells)} — counted OK: {ok}, skipped: {skipped}, "
        f"failed: {failed}",
    ]
    for mesh in ("card", "single", "multi"):
        sub = [d for (a, s, m), d in cells.items()
               if m == mesh and "roofline" in d]
        if not sub:
            continue
        key = "trace_s" if mesh == "card" else "place_s"
        times = sorted(d[key] for d in sub)
        lines.append(f"  {mesh}: {len(sub)} counted, median "
                     f"{key.split('_')[0]} {times[len(sub) // 2]:.1f}s")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="card",
                    choices=("card", "single", "multi"))
    ap.add_argument("--csv", action="store_true")
    ap.add_argument("--report-dir", default=REPORT_DIR)
    args = ap.parse_args(argv)
    cells = load_cells(args.report_dir)
    print(dryrun_summary(cells))
    rows = roofline_rows(cells, args.mesh)
    if args.csv:
        import csv
        import sys

        w = csv.DictWriter(sys.stdout, fieldnames=list(rows[0].keys()))
        w.writeheader()
        for r in rows:
            w.writerow(r)
    else:
        print(markdown_table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
