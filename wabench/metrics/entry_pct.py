"""entry_pct: the fleet entry's self time (the ``fleet.*`` spans: the state
build, the stream draw, the read-back, and the page-rate rows and glue of
``simulate_fleet`` itself), as a share of the traced experiment's wall time
(its ``fleet.simulate`` span). From the program's spans
(``repro_torch.utils.spans``); the six shares sum to 100."""

from wabench import layers


def read(rec):
    return layers.share("fleet entry")
