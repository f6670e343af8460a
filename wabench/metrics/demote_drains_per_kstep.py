"""demote_drains_per_kstep: the demoting GC drains (``_gc_drain_bulk``,
one ``compact_slots`` launch and one host read each) per 1,000 events of
each drive's stream, over the window. None where no drain demotes (a
static detector drains inside the GC kernel)."""


def read(rec):
    n = rec["counts"]["compact_slots_launches"]
    return n / rec["ksteps"] if n else None
