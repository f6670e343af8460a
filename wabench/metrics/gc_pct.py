"""gc_pct: the GC's self time (``gc.gc``, ``gc.valve``, ``gc.movement``: the
``gc_one`` launch and what follows a deciding launch; ``gc.demote_drain``:
each demoting drain), as a share of the traced experiment's wall time (its
``fleet.simulate`` span). From the program's spans
(``repro_torch.utils.spans``); the six shares sum to 100."""

from wabench import layers


def read(rec):
    return layers.share("GC")
