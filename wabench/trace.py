"""Reading the profiler's trace of a window: the device's busy time as the
union of its operations' intervals, each operation's time by name, and the
idle gaps between them labelled with the host operation that was running
(the innermost one on the thread that launched most)."""

from __future__ import annotations

import collections


def events(prof):
    """(device ops [(name, start, end)], host ops [(name, start, end)] of
    the busiest host thread), times in ns, each list sorted by start."""
    dev, host = [], collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.end_ns()
        if end <= start:
            continue
        if str(e.device_type()).endswith("CUDA"):
            dev.append((e.name(), start, end))
        elif str(e.device_type()).endswith("CPU"):
            host[e.start_thread_id()].append((e.name(), start, end))
    main = max(host.values(), key=len) if host else []
    return sorted(dev, key=lambda x: x[1]), sorted(main, key=lambda x: x[1])


def union(dev):
    """The device's busy intervals: the union of its operations'."""
    out = []
    for _, s, e in dev:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def innermost(host, points):
    """The innermost host op running at each of the sorted ``points``
    (None where none runs): a sweep that keeps the open ops as a stack."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][1] <= p:
            while stack and stack[-1][2] <= host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < p:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def summarize(prof, t0_ns=None, t1_ns=None, top=10) -> dict:
    """busy seconds, each device op's seconds by name, the top device ops
    and the idle gaps (by the host op running in them) over the window
    [t0, t1] (default: the span of the trace's events)."""
    dev, host = events(prof)
    busy = union(dev)
    if t0_ns is None:
        t0_ns = min([s for _, s, _ in dev] + [s for _, s, _ in host])
        t1_ns = max([e for _, _, e in dev] + [e for _, _, e in host])
    busy = [[max(s, t0_ns), min(e, t1_ns)] for s, e in busy
            if e > t0_ns and s < t1_ns]
    busy_s = sum(e - s for s, e in busy) * 1e-9
    by_name = collections.Counter()
    for name, s, e in dev:
        by_name[name] += (e - s) * 1e-9
    edges = [t0_ns] + [x for iv in busy for x in iv] + [t1_ns]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    labels = innermost(host, [(a + b) // 2 for a, b in gaps])
    idle = collections.Counter()
    for (a, b), label in zip(gaps, labels):
        idle[label or "python (no op)"] += (b - a) * 1e-9
    return {
        "busy_s": busy_s,
        "window_s": (t1_ns - t0_ns) * 1e-9,
        "kernel_s": dict(by_name),
        "device_ops": [[n, s] for n, s in by_name.most_common(top)],
        "idle_gaps": [[n, s] for n, s in idle.most_common(top)],
        "n_device_ops": len(dev),
    }

