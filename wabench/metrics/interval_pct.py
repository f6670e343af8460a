"""interval_pct: the §5.1 interval's self time (``sim.interval``: the EWMA,
§5.2 create and merge, the §5.5 allocation), as a share of the traced
experiment's wall time (its ``fleet.simulate`` span). From the program's
spans (``repro_torch.utils.spans``); the six shares sum to 100."""

from wabench import layers


def read(rec):
    return layers.share("interval")
