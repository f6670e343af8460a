"""The span recorder (``repro_torch.utils.spans``) and the simulator's
spans, on the CPU: recording is on only under a torch profiler, changes no
result, counts what the program's counters count, nests, and stamps the
profiler's own clock."""

import bisect
import collections
import time

import numpy as np
import pytest
import torch

from repro_torch.core import fleet, managers, simulator, workloads
from repro_torch.core.ssd import Geometry
from repro_torch.kernels.gc_one import ref as gc_ref
from repro_torch.utils import spans

GEOM = Geometry(4, 32, 8)
EVENTS, DRIVES = 300, 2
SLACK_NS = 50_000  # the clock test's allowance, 50 µs
GC_MODES = ("gc.gc", "gc.valve", "gc.movement")
# what each wrapped launch must lie inside
INSIDE = {"write_run_": ("sim.round",), "gc_one_": GC_MODES,
          "compact_slots_": ("gc.demote_drain",)}
# the module that calls each launch (the demoting drain's compact_slots_:
# the GC kernel's plain version, which the CPU runs)
CALLER = {"write_run_": simulator, "gc_one_": simulator,
          "compact_slots_": gc_ref}


def fleet_specs(kind: str):
    lba = GEOM.lba_pages
    if kind == "wolf":
        return [fleet.DriveSpec(managers.wolf(),
                                (workloads.two_modal(lba, EVENTS),), seed=d)
                for d in range(DRIVES)]
    # TPC-C churn (TRIMs) under the bloom detector: demoting drains
    return [fleet.DriveSpec(managers.wolf_dynamic(),
                            (workloads.tpcc_churn(lba, EVENTS),), seed=d)
            for d in range(DRIVES)]


def run(kind: str):
    return fleet.simulate_fleet(GEOM, fleet_specs(kind), return_lbas=True,
                                device="cpu")


def wrapped(name, fn, calls):
    """``fn`` counted in ``calls`` and marked in the profiler's trace."""
    def call(*args, **kw):
        calls[name] += 1
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return call


@pytest.fixture(scope="module", params=["wolf", "wolf_dynamic"])
def traced(request):
    """One fleet run without a profiler, then the same run under one, the
    three launches wrapped; each with a recorder of its own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spans, "RECORDER", spans.Recorder())
        plain = run(request.param)
        recorded_plain = len(spans.RECORDER.spans)
        rec = spans.Recorder()
        mp.setattr(spans, "RECORDER", rec)
        calls = collections.Counter()
        for name, module in CALLER.items():
            mp.setattr(module, name,
                       wrapped(name, getattr(module, name), calls))
        before = (simulator.rounds, simulator.host_syncs)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            res = run(request.param)
        counts = {"rounds": simulator.rounds - before[0],
                  "host_syncs": simulator.host_syncs - before[1]}
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.end_ns() > e.start_ns()]
    return {"kind": request.param, "plain": plain, "res": res, "rec": rec,
            "recorded_plain": recorded_plain, "calls": calls,
            "counts": counts, "events": events}


def test_profiler_changes_no_result(traced):
    plain, res = traced["plain"], traced["res"]
    for k in ("app", "mig", "lbas"):
        np.testing.assert_array_equal(getattr(res, k), getattr(plain, k))
    for d in range(DRIVES):
        a, b = dict(plain.state(d).items()), dict(res.state(d).items())
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_no_profiler_records_nothing(traced):
    assert traced["recorded_plain"] == 0
    assert spans.span("sim.round") is spans.span("host.sync")
    with spans.span("sim.round") as s:
        assert s is spans.span("gc.gc")


def names(traced) -> collections.Counter:
    return collections.Counter(s.name for s in traced["rec"].spans)


def test_span_counts_are_the_program_counts(traced):
    n, calls = names(traced), traced["calls"]
    assert n["fleet.simulate"] == 1 and traced["rec"].dropped == 0
    assert n["sim.round"] == traced["counts"]["rounds"] == \
        calls["write_run_"] > 0
    assert n["host.sync"] == traced["counts"]["host_syncs"] > 0
    assert sum(n[m] for m in GC_MODES) == calls["gc_one_"] > 0
    assert n["gc.demote_drain"] == calls["compact_slots_"]
    assert (n["gc.demote_drain"] > 0) == (traced["kind"] == "wolf_dynamic")
    assert set(n) <= set(spans.LAYERS)


def test_every_parent_is_open_around_its_child(traced):
    by_id = {s.id: s for s in traced["rec"].spans}
    assert len(by_id) == len(traced["rec"].spans)
    for s in traced["rec"].spans:
        assert s.start_ns <= s.end_ns
        if s.name == "fleet.simulate":
            assert s.parent is None
            continue
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_six_shares_sum_to_100(traced):
    b = spans.fleet_breakdown(traced["rec"])
    assert set(b["layers"]) == set(spans.LAYERS.values())
    assert len(b["layers"]) == 6
    total = sum(100.0 * v["self_ns"] / b["wall_ns"]
                for v in b["layers"].values())
    assert abs(total - 100.0) <= 0.5
    assert all(v["self_ns"] >= 0 for v in b["names"].values())
    assert b["names"]["sim.round"]["count"] == names(traced)["sim.round"]


def inside(lo, hi, of):
    """Whether [lo, hi] lies inside one of the spans ``of``, within the
    slack."""
    return any(s.start_ns - SLACK_NS <= lo and hi <= s.end_ns + SLACK_NS
               for s in of)


def test_launches_land_inside_their_spans_on_the_profilers_clock(traced):
    """Each wrapped launch, and every aten op the profiler recorded inside
    it, lies inside a span of its kind: the spans and the profiler's host
    events share one clock."""
    events = traced["events"]
    aten = sorted((a, b) for n, a, b in events if n.startswith("aten::"))
    aten_starts = [a for a, _ in aten]
    seen = collections.Counter()
    for name, kinds in INSIDE.items():
        # spans of one kind never nest: the one around a launch is the
        # last to start before it
        of = sorted((s.start_ns, s.end_ns) for s in traced["rec"].spans
                    if s.name in kinds)
        starts = [a for a, _ in of]
        marks = [(a, b) for n, a, b in events if n == name]
        assert len(marks) == traced["calls"][name]
        for a, b in marks:
            i = bisect.bisect_right(starts, a + SLACK_NS) - 1
            assert i >= 0, name
            lo, hi = of[i][0] - SLACK_NS, of[i][1] + SLACK_NS
            assert lo <= a and b <= hi, name
            k = bisect.bisect_left(aten_starts, a)
            while k < len(aten) and aten[k][0] <= b:
                if aten[k][1] <= b:  # recorded inside the launch
                    assert lo <= aten[k][0] and aten[k][1] <= hi, name
                    seen[name] += 1
                k += 1
    assert seen["write_run_"] > 0 and seen["gc_one_"] > 0


def test_aten_ops_lie_inside_the_span_they_ran_in(monkeypatch):
    """Spans 1 ms apart, each around one op of its own: the profiler's
    i-th ``aten::full`` lies inside the i-th span and no other."""
    rec = spans.Recorder()
    monkeypatch.setattr(spans, "RECORDER", rec)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(8):
            time.sleep(1e-3)
            with spans.span("host.sync"):
                torch.full((i + 1,), float(i))
    ops = sorted((e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::full")
    assert len(ops) == len(rec.spans) == 8
    for (a, b), s in zip(ops, sorted(rec.spans, key=lambda s: s.start_ns)):
        assert s.start_ns - SLACK_NS <= a and b <= s.end_ns + SLACK_NS
        assert sum(inside(a, b, [t]) for t in rec.spans) == 1


def test_spans_past_the_cap_are_counted_not_kept(monkeypatch):
    rec = spans.Recorder(cap=3)
    monkeypatch.setattr(spans, "RECORDER", rec)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("fleet.simulate"):
            for _ in range(4):
                with spans.span("host.sync"):
                    pass
    assert len(rec.spans) == 3 and rec.dropped == 2
    assert spans.fleet_breakdown(rec) is None  # the root was not kept
