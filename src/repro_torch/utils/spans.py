"""Spans of the simulator's layers: where a fleet experiment's host time
goes, recorded only while a torch profiler is active.

``span(name)`` is a context manager. With no profiler active
(``torch.autograd._profiler_enabled()``, about 0.1 µs) it returns one
shared object that does nothing: no allocation, no device read, no other
profiler call. Under a profiler it records the span's name, its own id,
the id of the span open around it on the thread, and its start and end
from ``time.time_ns()``: Unix-epoch nanoseconds, the clock the profiler
stamps its host events with, so a trace's events can be put down to the
innermost span open around them. A span ends when its host code returns;
it adds no device synchronisation.

A span is not a ``torch.profiler.record_function`` range: with CUDA
activity on, Kineto mirrors such a range onto the device's timeline as a
``gpu_user_annotation`` event of device type CUDA, which a reader that
takes every CUDA event for a device op would count as busy time.

Spans are kept in memory, at most :data:`CAP` of them; later ones are
counted in ``Recorder.dropped``. :func:`fleet_breakdown` reads the last
completed ``fleet.simulate`` span and its descendants by layer.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch

CAP = 1 << 20

# every span the program records, and the layer its self time belongs to
LAYERS = {
    "fleet.simulate": "fleet entry",
    "fleet.build": "fleet entry",
    "fleet.streams": "fleet entry",
    "fleet.readback": "fleet entry",
    "sim.round": "run loop",
    "sim.heavy_tail": "heavy tail",
    "gc.gc": "GC",
    "gc.valve": "GC",
    "gc.movement": "GC",
    "gc.demote_drain": "GC",
    "sim.interval": "interval",
    "host.sync": "device reads",
}

_profiler_enabled = torch.autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    id: int
    parent: int | None  # the span open around it on its thread
    start_ns: int
    end_ns: int


class Recorder:
    """The spans recorded so far, in the order they ended."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.spans: list[Span] = []
        self.dropped = 0
        self.ids = itertools.count(1)
        self._local = threading.local()

    def open_ids(self) -> list[int]:
        """This thread's open spans, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def keep(self, s: Span) -> None:
        if len(self.spans) < self.cap:
            self.spans.append(s)
        else:
            self.dropped += 1


RECORDER = Recorder()


class _Off:
    """The span of a run with no profiler."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, exc, tb):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("rec", "name", "id", "parent", "start_ns")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        stack = self.rec.open_ids()
        self.parent = stack[-1] if stack else None
        self.id = next(self.rec.ids)
        stack.append(self.id)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, typ, exc, tb):
        end = time.time_ns()
        self.rec.open_ids().pop()
        self.rec.keep(Span(self.name, self.id, self.parent, self.start_ns,
                           end))
        return False


def span(name: str):
    """A span named ``name`` (one of :data:`LAYERS`) around a ``with``
    block, recorded only while a torch profiler is active."""
    if not _profiler_enabled():
        return _OFF
    return _On(RECORDER, name)


def _covered(lo: int, hi: int, kids: list[Span]) -> int:
    """Nanoseconds of [lo, hi] that the intervals of ``kids`` cover."""
    total, reach = 0, lo
    for k in sorted(kids, key=lambda k: k.start_ns):
        a, b = max(k.start_ns, reach), min(k.end_ns, hi)
        if b > a:
            total += b - a
            reach = b
    return total


def fleet_breakdown(recorder: Recorder | None = None) -> dict | None:
    """The last completed ``fleet.simulate`` span and its descendants:
    ``wall_ns``, the root's duration, and for each layer (``layers``) and
    each span name (``names``) the self time (a span's duration less what
    its child spans cover), the count and the total duration, in ns. Every
    layer of :data:`LAYERS` is there, at 0 where no span of it ran, and the
    layers' self times sum to ``wall_ns``. None where no such span ended."""
    spans = (recorder or RECORDER).spans
    root = next((s for s in reversed(spans) if s.name == "fleet.simulate"),
                None)
    if root is None:
        return None
    children: dict[int, list[Span]] = {}
    for s in spans:
        if s.parent is not None:
            children.setdefault(s.parent, []).append(s)

    def zero():
        return {"self_ns": 0, "count": 0, "total_ns": 0}

    layers = {layer: zero() for layer in LAYERS.values()}
    names: dict[str, dict] = {}
    todo = [root]
    while todo:
        s = todo.pop()
        kids = children.get(s.id, [])
        todo += kids
        dur = s.end_ns - s.start_ns
        self_ns = dur - _covered(s.start_ns, s.end_ns, kids)
        for stat in (layers.setdefault(LAYERS.get(s.name, s.name), zero()),
                     names.setdefault(s.name, zero())):
            stat["self_ns"] += self_ns
            stat["count"] += 1
            stat["total_ns"] += dur
    return {"wall_ns": root.end_ns - root.start_ns, "layers": layers,
            "names": names}
