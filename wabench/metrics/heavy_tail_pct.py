"""heavy_tail_pct: the heavy tail's self time (``sim.heavy_tail``: invalidate,
target group, append, the valve loop; not its GCs), as a share of the
traced experiment's wall time (its ``fleet.simulate`` span). From the
program's spans (``repro_torch.utils.spans``); the six shares sum to 100."""

from wabench import layers


def read(rec):
    return layers.share("heavy tail")
