"""The program's spans of the traced experiment, by layer: what
``repro_torch.utils.spans.fleet_breakdown`` reads from the last completed
``fleet.simulate`` span (the harness profiles only the first experiment,
and the program records spans only under a profiler). None where the
program records no span, or none of that experiment."""

from __future__ import annotations

import importlib


def breakdown() -> dict | None:
    try:
        spans = importlib.import_module("repro_torch.utils.spans")
    except ModuleNotFoundError:  # a program without spans
        return None
    return spans.fleet_breakdown()


def share(layer: str) -> float | None:
    """The layer's self time as a % of the experiment's wall time."""
    b = breakdown()
    if b is None or b["wall_ns"] <= 0:
        return None
    return 100.0 * b["layers"][layer]["self_ns"] / b["wall_ns"]
