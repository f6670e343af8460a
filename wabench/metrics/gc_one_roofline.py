"""gc_one_roofline: the GC kernel's share of its roofline over the
traced experiment, where it drains (the static detector): the bytes the
GCs need at the card's HBM rate, over its kernel time in the profiler's
trace. None where the kernel only decides (a demoting detector drains on
the host).

The work is fixed by the GCs and the pages they moved, not by the kernel:
a GC reads its victim's valid bytes (1 a slot) and each live page's number
(4); each live page it moves clears its old valid byte (1), writes its map
entry (4) and its new slot's page number and valid byte (5). The choice of
the victim, the erase's reset of the victim's page numbers (a dead slot is
told by its valid byte alone) and the block and group counters are left
out: a lower bound."""

KERNEL = "gc_one_kernel"


def need(gcs: int, pages: int, pages_per_block: int) -> tuple[int, int]:
    """(bytes read, bytes written) by ``gcs`` drained GCs that moved
    ``pages`` live pages."""
    return gcs * pages_per_block + pages * 4, pages * 10


def read(rec):
    t = rec["traced"]
    if rec["op_stream"] or not t or not t["summary"]:
        return None
    secs = sum(s for n, s in t["summary"]["kernel_s"].items() if KERNEL in n)
    gcs, pages = t["work"]["n_erase"], t["work"]["n_mig"]
    if secs <= 0 or gcs <= 0:
        return None
    total = sum(need(gcs, pages, rec["pages_per_block"]))
    return 100.0 * total / rec["hbm_bytes_per_s"] / secs
