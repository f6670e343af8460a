"""The readers of the program's spans: each new metric's value on a
hand-built span tree with known self times, None where the program
recorded no experiment or records no span, and every metric read through
a traced run of a small cell on the CPU."""

import json
import sys
import time

import pytest
from wabench_small import small_cell

from repro_torch.utils import spans
from wabench import cell as cells
from wabench import harness

MS = 1_000_000  # ns
SHARES = ("entry_pct", "run_loop_pct", "heavy_tail_pct", "gc_pct",
          "interval_pct", "sync_wait_pct")
NEW = SHARES + ("demote_drain_ms",)
BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())


def tree(with_drain: bool = True) -> list:
    """(name, id, parent, start, end in ms), in the order spans end: an
    older experiment, then the one the readers read."""
    rows = [
        ("sim.round", 1, 2, 1, 2),
        ("fleet.simulate", 2, None, 0, 5),  # older: left out
        ("fleet.build", 11, 10, 10, 110),
        ("host.sync", 13, 12, 110, 160),
        ("host.sync", 19, 17, 270, 280),
        ("gc.demote_drain", 17, 16, 260, 360),
        ("gc.gc", 16, 14, 210, 410),
        ("sim.interval", 18, 14, 410, 490),
        ("sim.heavy_tail", 14, 12, 160, 510),
        ("sim.round", 12, 10, 110, 610),
        ("host.sync", 21, 20, 610, 710),
        ("sim.round", 20, 10, 610, 910),
        ("fleet.readback", 22, 10, 960, 1010),
        ("fleet.simulate", 10, None, 10, 1010),
    ]
    if not with_drain:  # the drain's time is the GC's own
        rows = [r for r in rows if r[1] not in (17, 19)]
    return [spans.Span(n, i, p, a * MS, b * MS) for n, i, p, a, b in rows]


# self times: entry 50 + 100 + 50, run loop 100 + 200, heavy tail 70, GC
# 100 + 90, interval 80, device reads 50 + 10 + 100; of 1,000 ms
EXPECTED = {"entry_pct": 20.0, "run_loop_pct": 30.0, "heavy_tail_pct": 7.0,
            "gc_pct": 19.0, "interval_pct": 8.0, "sync_wait_pct": 16.0,
            "demote_drain_ms": 100.0}


def recorded(monkeypatch, rows):
    rec = spans.Recorder()
    rec.spans.extend(rows)
    monkeypatch.setattr(spans, "RECORDER", rec)


@pytest.mark.parametrize("name", NEW)
def test_reader_on_a_hand_built_tree(monkeypatch, name):
    recorded(monkeypatch, tree())
    assert cells.reader(name)({}) == pytest.approx(EXPECTED[name])


def test_shares_sum_to_100_and_no_drain_reads_none(monkeypatch):
    recorded(monkeypatch, tree(with_drain=False))
    values = {n: cells.reader(n)({}) for n in NEW}
    assert values["demote_drain_ms"] is None
    assert values["gc_pct"] == pytest.approx(20.0)
    assert sum(values[n] for n in SHARES) == pytest.approx(100.0)


@pytest.mark.parametrize("name", NEW)
def test_no_root_reads_none(monkeypatch, name):
    recorded(monkeypatch, [r for r in tree() if r.name != "fleet.simulate"])
    assert cells.reader(name)({}) is None
    recorded(monkeypatch, [])
    assert cells.reader(name)({}) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_reads_none(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "repro_torch.utils.spans", None)
    assert cells.reader(name)({}) is None


def test_new_metrics_are_program_spans_of_named_layers():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    both = [w["name"] for w in BENCH["workloads"]]
    for name in NEW:
        m = entries[name]
        assert m["source"] == "program_span"
        assert m["layer"] in set(spans.LAYERS.values())
        assert m["moves"] == "events_per_s" and m["better"] == "lower"
        assert m["workloads"] == (["dyn_tpcc_churn_d8"]
                                  if name == "demote_drain_ms" else both)


def test_traced_small_run_reads_every_span_metric(monkeypatch):
    """A traced run of the churn cell cut small, on the CPU: the six
    shares read and sum to 100, and a drain's mean reads."""
    monkeypatch.setattr(spans, "RECORDER", spans.Recorder())
    c = small_cell("dyn_tpcc_churn_d8", drives=2, events=400)
    line, _ = harness.run_cell(c, 2**31 + 7, 0.1, True, "cpu",
                               time.perf_counter(), workers=1)
    got = line["metrics"]
    assert line["correct"] and set(NEW) <= set(got)
    assert abs(sum(got[n]["value"] for n in SHARES) - 100.0) <= 0.5
    assert got["demote_drain_ms"]["value"] > 0
    assert got["demote_drain_ms"]["unit"] == "ms"
