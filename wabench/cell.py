"""A cell of the benchmark, found by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic file under ``traffic/`` and the
readers of its per-layer metrics under ``metrics/``. Adding a cell, a
configuration, a traffic mix or a metric adds files and entries; no file
here names one."""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries, name, what):
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries")
    return found[0]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, root=ROOT) -> dict:
    """Everything a run of workload ``name`` needs, from the files under
    the checkout ``root``."""
    root = pathlib.Path(root)
    bench = load_json(root / "BENCHMARK.json")
    work = _by_name(bench["workloads"], name, "workload")
    cfg_entry = _by_name(bench["configs"], work["config"], "config")
    return {
        "name": name,
        "root": str(root),
        "chips": int(work["chips"]),
        "config": load_json(root / cfg_entry["file"]),
        "traffic": load_json(root / HERE.name / "traffic"
                             / f"{work['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if _applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, name)],
    }


def reader(metric: str, root=ROOT):
    """The reader of per-layer metric ``metric``: the ``read(record)`` of
    ``metrics/<metric>.py`` under the checkout ``root``, which returns a
    number or None (nothing to read)."""
    path = pathlib.Path(root) / HERE.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"wabench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
