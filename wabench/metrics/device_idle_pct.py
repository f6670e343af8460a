"""device_idle_pct: the share of the traced experiment's wall time in
which no operation ran on the card (the union of the device operations'
intervals from the profiler's trace, against the host clock)."""


def read(rec):
    t = rec["traced"]
    if not t or not t["summary"] or t["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["summary"]["busy_s"] / t["wall_s"])
