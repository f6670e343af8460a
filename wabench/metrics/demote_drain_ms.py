"""demote_drain_ms: the mean duration of one demoting GC drain
(``gc.demote_drain``: ``_gc_drain_bulk`` for one drive, its read of the
flagged slots and their targets included) over the traced experiment, in
ms. From the program's spans (``repro_torch.utils.spans``). None where no
drain demotes (a static detector drains inside the GC kernel)."""

from wabench import layers


def read(rec):
    b = layers.breakdown()
    drains = b and b["names"].get("gc.demote_drain")
    if not drains:
        return None
    return drains["total_ns"] / drains["count"] * 1e-6
